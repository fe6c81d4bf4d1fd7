"""Block-structured factorization of the condensed KKT matrix.

The condensed KKT matrix ``K = H + Σ + δI + Jᵀ D J`` of the transcribed OCP
(see :mod:`.ipm`) is not dense: with the per-phase variable layout
``[X, U, t0, tf, q]`` (``transcribe.PhaseLayout``) every coupling is local —

* Lagrangian-Hessian node blocks touch ``(x_k, u_k, t0, tf, q)`` only
  (:mod:`.structured`),
* defect rows touch one segment's state support points + that node's control
  + ``(t0, tf, q)`` (the composite ``D`` is block bi-diagonal,
  ``ops/lgr.py``; reference sparsity: ``LpNLPWrapper.cpp:1106-1548``),
* path rows are node-local; event/linkage/Mayer blocks touch only endpoint
  states and ``(t0, tf, q)``.

Permuting to [segment-interior variables | separators] therefore makes the
interior **exactly block-diagonal**: one dense block per segment holding the
segment's interior state points (all but the shared boundary points) and its
controls, with a small dense border of separators (segment-boundary states,
``t0``, ``tf``, ``q`` of every phase) — a depth-1 nested-dissection ordering
of the banded-block sparsity MUMPS exploits inside IPOPT for the reference
(``LpNLPSolver.cpp``). All segment blocks factorize as ONE batched Cholesky,
the border couples them through a single small Schur complement, and every
shape is static.

Counterpart of the JAX package's ``core/block_kkt.py``, with an explicit
leading instance axis: ``K`` is (B, n, n), the blocks (B, S, b, b), the
border (B, nb, nb), and :func:`make_block_factorizer`'s ``factor_ok`` gives
one flag per instance. Cost per factorization is ``O(S·b³)`` batched plus
one ``O(nb³)`` Schur factorization instead of the dense ``O(n³)``.

The segment axis is the seam along which :mod:`..parallel.segment` splits
one instance over ranks: under its policy the blocks are this rank's share,
the border Schur matrix and right-hand side are summed over the ranks, and
the interior solution is gathered (the ``seg_*`` hooks, no-ops outside a
policy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.blocked_chol import chol_and_inverse
from ..parallel.segment import (seg_active, seg_constrain, seg_gather, seg_lead, seg_replicated,
                                seg_share)
from .transcribe import Layout


@dataclass(frozen=True)
class BlockKKTSpec:
    """Static permutation data for the block factorization.

    ``interior_idx[s, j]`` is the global variable index of slot ``j`` in
    segment block ``s`` (0-padded where ``interior_mask`` is False);
    ``border_idx`` lists the separator variables. Together they cover every
    variable exactly once.
    """

    interior_idx: np.ndarray    # (S, bmax) int32
    interior_mask: np.ndarray   # (S, bmax) bool
    border_idx: np.ndarray      # (nb,) int32
    n: int

    @property
    def num_blocks(self) -> int:
        return int(self.interior_idx.shape[0])

    @property
    def block_size(self) -> int:
        return int(self.interior_idx.shape[1])

    @property
    def border_size(self) -> int:
        return int(self.border_idx.shape[0])


def make_block_spec(layout: Layout, ops) -> BlockKKTSpec | None:
    """Build the interior/border permutation from the phase layouts.

    Returns None when there is nothing to condense (no interior variables:
    e.g. every segment has degree 1 and no controls).
    """
    blocks: list[np.ndarray] = []
    border: list[np.ndarray] = []
    for pl, op in zip(layout.phases, ops):
        nx, nu = pl.nx, pl.nu
        x_base = pl.var_offset
        u_base = pl.var_offset + pl.npts * nx
        # separator state points: the segment boundaries (first point of each
        # segment) plus the final point N — shared between adjacent segment
        # supports and touched by events/linkages/Mayer.
        sep_pts = list(op.seg_starts) + [pl.N]
        for k, deg in enumerate(op.degrees):
            start = op.seg_starts[k]
            inner_pts = np.arange(start + 1, start + deg)  # deg-1 interior points
            cols = []
            if nx:
                cols.append((x_base + inner_pts[:, None] * nx + np.arange(nx)).ravel())
            if nu:
                u_nodes = np.arange(start, start + deg)
                cols.append((u_base + u_nodes[:, None] * nu + np.arange(nu)).ravel())
            blocks.append(
                np.concatenate(cols).astype(np.int32) if cols
                else np.zeros((0,), np.int32)
            )
        if nx:
            border.append(
                (x_base + np.asarray(sep_pts)[:, None] * nx + np.arange(nx))
                .ravel().astype(np.int32)
            )
        border.append(np.array([pl.t0_index, pl.tf_index], np.int32))
        if pl.nq:
            border.append(
                (pl.q_slice.start + np.arange(pl.nq)).astype(np.int32)
            )
    bmax = max((b.shape[0] for b in blocks), default=0)
    if bmax == 0:
        return None
    S = len(blocks)
    interior_idx = np.zeros((S, bmax), np.int32)
    interior_mask = np.zeros((S, bmax), bool)
    for s, b in enumerate(blocks):
        interior_idx[s, : b.shape[0]] = b
        interior_mask[s, : b.shape[0]] = True
    border_idx = np.concatenate(border).astype(np.int32)
    # sanity: exact cover of all variables
    all_idx = np.concatenate([interior_idx[interior_mask].ravel(), border_idx])
    assert all_idx.shape[0] == layout.nvar and np.array_equal(
        np.sort(all_idx), np.arange(layout.nvar)
    ), "block spec must cover every variable exactly once"
    return BlockKKTSpec(
        interior_idx=interior_idx, interior_mask=interior_mask,
        border_idx=border_idx, n=layout.nvar,
    )


class BlockFactor(NamedTuple):
    """Every field has a leading instance axis (B)."""

    L: torch.Tensor       # (B, S, b, b) block Cholesky factors (inertia check)
    W: torch.Tensor       # (B, S, b, nb) A_s^{-1} B_sᵀ
    Ls: torch.Tensor      # (B, nb, nb) border Schur Cholesky factor (inertia check)
    B: torch.Tensor       # (B, S, nb, b) border-interior coupling
    Ainv: torch.Tensor    # (B, S, b, b) explicit interior-block inverses
    Sinv: torch.Tensor    # (B, nb, nb) explicit Schur inverse


def factor_from_blocks(A, B, C) -> BlockFactor:
    """Block Cholesky + border Schur from already-assembled blocks:
    ``A`` (B, S, b, b) interior (padded slots must carry identity), ``B``
    (B, S, nb, b) border-interior coupling (padded slots zero), ``C``
    (B, nb, nb) border block.

    Uses the recursive blocked factorization of :mod:`..ops.blocked_chol`
    (as the JAX package does) and stores explicit inverses, so every
    downstream solve is a batched matvec.

    Under a segment-sharding policy ``A`` and ``B`` hold this rank's share
    of the segments and ``C`` its partial of the border block; the Schur
    matrix is summed over the ranks (one ``all_reduce``). A rank whose own
    blocks failed sends NaN, so every rank's Schur factor fails with it and
    :func:`make_block_factorizer`'s ``factor_ok`` agrees on every rank."""
    L, Li = chol_and_inverse(A)
    Ainv = Li.transpose(-1, -2) @ Li
    W = Ainv @ B.transpose(-1, -2)                            # (B, S, b, nb)
    Schur = C - torch.einsum("zsnb,zsbm->znm", B, W)
    if seg_active():
        own_ok = _diag_ok(L)
        Schur = seg_replicated(torch.where(own_ok[:, None, None], Schur, float("nan")))
    Ls, Lsi = chol_and_inverse(Schur)
    Sinv = Lsi.transpose(-1, -2) @ Lsi
    return BlockFactor(L=L, W=W, Ls=Ls, B=B, Ainv=Ainv, Sinv=Sinv)


def make_block_factorizer(spec: BlockKKTSpec):
    """Return ``(factorize, solve, factor_ok)`` closures over the spec.

    ``factorize(K) -> BlockFactor`` (K dense (B, n, n));
    ``solve(F, r) -> K⁻¹ r`` for ``r`` (B, n); ``factor_ok(F) -> (B,) bool``
    (all Cholesky diagonals finite and positive — same contract as the dense
    path).
    """
    by_device = {}

    def on(device):
        """The spec's index arrays as tensors on ``device`` (made once per
        segment share): this rank's share ``ii``, ``mask`` and pair mask
        (the whole spec outside a policy), the border, and the whole spec's
        mask and valid interior indices, where the gathered solution lands."""
        key = (str(device), seg_share(spec.num_blocks))
        if key not in by_device:
            t = lambda a: torch.as_tensor(a, device=device)
            ii_all = t(spec.interior_idx.astype(np.int64))
            mask_all = t(spec.interior_mask)
            ii, mask = seg_constrain(ii_all), seg_constrain(mask_all)
            by_device[key] = (ii, mask, t(spec.border_idx.astype(np.int64)),
                              mask[:, :, None] & mask[:, None, :], mask_all,
                              ii_all[mask_all])
        return by_device[key]

    def factorize(K):
        ii, mask, bi, pair_mask, _, _ = on(K.device)
        eye = torch.eye(spec.block_size, dtype=K.dtype, device=K.device)
        A = K[:, ii[:, :, None], ii[:, None, :]]              # (B, S, b, b)
        A = torch.where(pair_mask, A, eye)                    # pad slots -> identity
        Bm = K[:, bi[None, :, None], ii[:, None, :]]          # (B, S, nb, b)
        Bm = torch.where(mask[:, None, :], Bm, torch.zeros((), dtype=K.dtype, device=K.device))
        C = seg_lead(K[:, bi[:, None], bi[None, :]])
        return factor_from_blocks(A, Bm, C)

    def solve(F, r):
        ii, mask, bi, _, mask_all, ii_valid = on(r.device)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        r_int = torch.where(mask, r[:, ii], zero)                         # (B, S, b)
        y = torch.einsum("zsij,zsj->zsi", F.Ainv, r_int)
        rhs_b = seg_replicated(seg_lead(r[:, bi]) - torch.einsum("zsnb,zsb->zn", F.B, y))
        xb = torch.einsum("zij,zj->zi", F.Sinv, rhs_b)
        xi = seg_gather(y - torch.einsum("zsbn,zn->zsb", F.W, xb), spec.num_blocks)
        out = torch.zeros_like(r)
        out[:, bi] = xb
        out[:, ii_valid] = xi[:, mask_all]
        return out

    def factor_ok(F):
        return _diag_ok(F.L) & _diag_ok(F.Ls)

    return factorize, solve, factor_ok


def _diag_ok(L):
    """(B,) whether every diagonal entry of the (B, ..., k, k) factors ``L``
    is finite and positive."""
    d = torch.diagonal(L, dim1=-2, dim2=-1).flatten(1)
    return torch.isfinite(d).all(-1) & (d > 0.0).all(-1)
