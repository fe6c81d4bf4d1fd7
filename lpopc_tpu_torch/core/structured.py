"""Structure-exploiting derivative assembly for the transcribed NLP.

The transcription is node-separable: defects couple states only through the
constant composite differentiation matrix ``D``; the dynamics/path/Lagrange
terms act node-wise; events/linkages touch endpoints. So instead of one
global ``jacfwd``/``hessian`` over the whole decision vector, this module
builds

* **per-node derivative blocks** (:func:`make_jac_blocks`,
  :func:`make_hess_blocks`): vmapped Jacobians of the user functions and
  vmapped Hessians of the node Lagrangian
  ``σ (tf-t0)/2 w_k L_k - (tf-t0)/2 λ_kᵀ f_k + λ_kᵀ p_k`` (a function of
  ``[x_k; u_k; t0; tf; q]`` only) plus endpoint/linkage blocks, and
* dense assemblers placing those blocks around the constant ``kron(D, I)``
  skeleton (:func:`make_structured_jacobian_mesh`,
  :func:`make_structured_hessian_mesh`).

All functions here are SINGLE-INSTANCE (1-D ``z``); the batched solver lifts
them with ``torch.func.vmap``, so everything inside is written with
out-of-place, vmap-friendly ops.

**Assembly is a gather, not a scatter-add.** Several blocks land on the same
dense entry (every node touches the ``t0``/``tf``/``q`` columns). The block →
dense index map is static, so :class:`_GatherAssembly` precomputes, for every
dense entry that receives blocks, the list of block entries that sum into it
(padded per group of entries with similar counts) and evaluates
``sums = blocks[table].sum(-1)``, then places the sums with one more gather.
The summation order is fixed by the tables, so the result is bitwise
reproducible run to run — which ``index_put_(accumulate=True)`` on CUDA
(atomics) is not.

This mirrors what the reference hand-codes over ~5 kLoC
(``LpNLPWrapper::GetPhaseJacbi``, ``LpHessian::CalculatePhaseHessian`` —
``Lpopc/src/Core/LpNLPWrapper.cpp:230-862``, ``LpHessian.cpp:1192-2162``) but
with exact node-level AD instead of finite differences. Correctness is
pinned by tests comparing against global ``torch.func`` AD.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from ..ops.lgr import SegmentOps
from .problem import Problem
from .transcribe import Layout, _scalar, _vector, const_mesh, unpack_phase


def _node_indices(pl) -> np.ndarray:
    """(N, nb) global variable indices of node k's inputs [x_k, u_k, t0, tf, q]."""
    N, nx, nu, nq = pl.N, pl.nx, pl.nu, pl.nq
    idx = np.empty((N, nx + nu + 2 + nq), dtype=np.int64)
    for k in range(N):
        cols = []
        cols.extend(pl.var_offset + k * nx + np.arange(nx))
        cols.extend(pl.var_offset + pl.npts * nx + k * nu + np.arange(nu))
        cols.append(pl.t0_index)
        cols.append(pl.tf_index)
        cols.extend(pl.q_slice.start + np.arange(nq))
        idx[k] = cols
    return idx


def _endpoint_indices(pl) -> np.ndarray:
    """Global indices of [x0, t0, xf, tf, q]."""
    nx, nq = pl.nx, pl.nq
    return np.concatenate([
        pl.var_offset + np.arange(nx),
        [pl.t0_index],
        pl.var_offset + pl.N * nx + np.arange(nx),
        [pl.tf_index],
        pl.q_slice.start + np.arange(nq),
    ]).astype(np.int64)


def _link_indices(layout, link) -> np.ndarray:
    """Global indices of a linkage's inputs [xf_left, q_left, x0_right, q_right]."""
    pll, plr = layout.phases[link.left], layout.phases[link.right]
    return np.concatenate([
        pll.var_offset + pll.N * pll.nx + np.arange(pll.nx),
        pll.q_slice.start + np.arange(pll.nq),
        plr.var_offset + np.arange(plr.nx),
        plr.q_slice.start + np.arange(plr.nq),
    ]).astype(np.int64)


class PhaseJacBlocks(NamedTuple):
    dblocks: torch.Tensor   # (N, nx, nbn)   -(tf-t0)/2 ∂f/∂[x,u,t0,tf,q]
    pblocks: torch.Tensor   # (N, npath, nbn)
    eblock: torch.Tensor    # (nevent, ne)   ∂event/∂[x0,t0,xf,tf,q]


class PhaseHessBlocks(NamedTuple):
    hblocks: torch.Tensor   # (N, nbn, nbn) node-Lagrangian Hessians
    hend: torch.Tensor      # (ne, ne) endpoint (Mayer + event) Hessian


class _GatherAssembly:
    """Deterministic ``dense.flat[dest[i]] += src[i]`` for a static ``dest``.

    ``dest`` (numpy, duplicates allowed) maps every entry of the flattened
    source vector to an entry of a dense vector of length ``size``. Dense
    entries that receive sources are grouped by their source count rounded
    up to a power of two; each group's table ``(entries, width)`` lists the
    source positions that sum into each entry, in source order, padded with
    the index of an appended zero. A last gather places the sums (and zero
    elsewhere). Memory stays within twice the source count plus ``size``
    however unevenly the sources fall: the ``t0``/``tf`` entries of a phase
    receive one source per node, most others one or two.
    """

    def __init__(self, dest: np.ndarray, size: int):
        dest = np.asarray(dest, dtype=np.int64).reshape(-1)
        nsrc = dest.shape[0]
        order = np.argsort(dest, kind="stable")
        uniq, start, counts = np.unique(dest[order], return_index=True, return_counts=True)
        width = 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
        self._tables_np = []
        pos = np.full(size, uniq.shape[0], dtype=np.int64)   # the zero slot
        off = 0
        for w in np.unique(width):
            sel = np.nonzero(width == w)[0]
            ranks = np.arange(w)[None, :]
            valid = ranks < counts[sel][:, None]
            table = np.full((sel.shape[0], int(w)), nsrc, dtype=np.int64)
            table[valid] = order[(start[sel][:, None] + ranks)[valid]]
            self._tables_np.append(table)
            pos[uniq[sel]] = off + np.arange(sel.shape[0])
            off += sel.shape[0]
        self._pos_np = pos
        self._tables = {}

    def tables(self, device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = (
                [torch.as_tensor(t, device=device) for t in self._tables_np],
                torch.as_tensor(self._pos_np, device=device),
            )
        return self._tables[key]

    def __call__(self, src_flat: torch.Tensor) -> torch.Tensor:
        zero = src_flat.new_zeros(1)
        ext = torch.cat([src_flat, zero])
        tables, pos = self.tables(src_flat.device)
        sums = torch.cat([ext[t].sum(-1) for t in tables] + [zero])
        return sums[pos]


def _phase_node_inputs(pl, X, U, t0, tf, q):
    return torch.cat(
        [
            X[:-1],
            U,
            t0.expand(pl.N)[:, None],
            tf.expand(pl.N)[:, None],
            q.expand(pl.N, pl.nq),
        ],
        dim=1,
    )


def _jacobian(fn, dtype):
    """``jacfwd(fn)`` in float64. Below float64, ``jacrev(fn)``: forward-mode
    AD of a 0-d float32 tensor times a Python float carries a float64
    tangent, which breaks a float32 transcription (the two-stage batch
    solver's first stage); reverse mode keeps float32."""
    return jacfwd(fn) if dtype == torch.float64 else jacrev(fn)


def _hessian(fn, dtype):
    """``hessian(fn)`` in float64, ``jacrev(jacrev(fn))`` below (see
    :func:`_jacobian`)."""
    return hessian(fn) if dtype == torch.float64 else jacrev(jacrev(fn))


def _split_node(pl, xi):
    nx, nu = pl.nx, pl.nu
    return xi[:nx], xi[nx : nx + nu], xi[nx + nu], xi[nx + nu + 1], xi[nx + nu + 2 :]


def _endpoint_vector(X, t0, tf, q):
    return torch.cat([X[0], t0.reshape(1), X[-1], tf.reshape(1), q])


def make_jac_blocks(problem: Problem, layout: Layout) -> Callable:
    """Return ``jac_blocks(z, mesh) -> (phase_blocks, link_blocks)``.

    ``phase_blocks[p]`` is a :class:`PhaseJacBlocks`; ``link_blocks[l]`` is
    the (nlink, nl) Jacobian of linkage ``l``. The (constant) ``kron(D, I)``
    defect skeleton and the linear rows are NOT in the blocks — consumers add
    them from the mesh/layout.
    """

    def jac_blocks(z, mesh):
        phase_blocks = []
        ends, starts = [], []
        for ph, pl, (tau, _, _, _) in zip(problem.phases, layout.phases, mesh):
            X, U, t0, tf, q = unpack_phase(pl, z)

            # the node's collocation abscissa rides along as a vmapped input
            # (the value the reference reads as ``tau[k]``)
            def node_dyn(xi, tau_k):
                x, u, t0_, tf_, q_ = _split_node(pl, xi)
                t = (tau_k + 1.0) * (tf_ - t0_) / 2.0 + t0_
                f = ph.dynamics(x, u, t, q_)
                return -(tf_ - t0_) / 2.0 * _vector(f, z, pl.nx)

            xi_nodes = _phase_node_inputs(pl, X, U, t0, tf, q)
            # (N, nx, nbn)
            dblocks = vmap(_jacobian(node_dyn, z.dtype), in_dims=(0, 0))(xi_nodes, tau)

            nbn = xi_nodes.shape[1]
            if ph.npath > 0:
                def node_path(xi, tau_k):
                    x, u, t0_, tf_, q_ = _split_node(pl, xi)
                    t = (tau_k + 1.0) * (tf_ - t0_) / 2.0 + t0_
                    return _vector(ph.path(x, u, t, q_), z, pl.npath)

                pblocks = vmap(_jacobian(node_path, z.dtype), in_dims=(0, 0))(xi_nodes, tau)
            else:
                pblocks = z.new_zeros((pl.N, 0, nbn))

            ne = 2 * pl.nx + 2 + pl.nq
            if ph.nevent > 0:
                def ev(xe):
                    nx = pl.nx
                    return _vector(
                        ph.event(xe[:nx], xe[nx], xe[nx + 1 : 2 * nx + 1],
                                 xe[2 * nx + 1], xe[2 * nx + 2 :]),
                        z, pl.nevent,
                    )

                eblock = _jacobian(ev, z.dtype)(_endpoint_vector(X, t0, tf, q))  # (nevent, ne)
            else:
                eblock = z.new_zeros((0, ne))
            phase_blocks.append(
                PhaseJacBlocks(dblocks=dblocks, pblocks=pblocks, eblock=eblock)
            )
            starts.append((X[0], t0, q))
            ends.append((X[-1], tf, q))

        link_blocks = []
        for link in problem.linkages:
            if link.nlink == 0:
                link_blocks.append(z.new_zeros((0, 0)))
                continue
            pll, plr = layout.phases[link.left], layout.phases[link.right]
            xfl, tfl, ql = ends[link.left]
            x0r, t0r, qr = starts[link.right]
            nxl, nql, nxr = pll.nx, pll.nq, plr.nx

            def lk(v):
                return _vector(
                    link.fn(v[:nxl], v[nxl : nxl + nql],
                            v[nxl + nql : nxl + nql + nxr], v[nxl + nql + nxr :]),
                    z, link.nlink,
                )

            v = torch.cat([xfl, ql, x0r, qr])
            link_blocks.append(_jacobian(lk, z.dtype)(v))
        return phase_blocks, link_blocks

    return jac_blocks


def make_hess_blocks(
    problem: Problem, layout: Layout, gauss_newton: bool = False
) -> Callable:
    """Return ``hess_blocks(z, lam, mesh, sigma=1.0) ->
    (phase_hblocks, link_hblocks)`` — the per-node / endpoint / linkage
    pieces of the Lagrangian Hessian ``∇²[σ f(z) + λᵀ c(z)]``.

    ``gauss_newton`` drops every constraint-curvature term (``λᵀ∇²c``:
    dynamics, path, event and linkage second derivatives), keeping only the
    objective's — the Gauss-Newton Lagrangian-Hessian approximation the
    reference exposes as ``hessian-approximation`` (``LpNLPSolver.cpp:31-44``).
    Always positive-semidefinite on the objective, cheaper per iteration for
    dynamics with expensive second derivatives, at the cost of a linear
    (not quadratic) local convergence rate."""

    def hess_blocks(z, lam, mesh, sigma=1.0):
        phase_h = []
        ends, starts = [], []
        for ph, pl, (tau, _, w, _) in zip(problem.phases, layout.phases, mesh):
            X, U, t0, tf, q = unpack_phase(pl, z)
            lam_def = lam[pl.con_offset : pl.con_offset + pl.N * pl.nx].reshape(
                pl.N, pl.nx
            )
            if ph.npath > 0:
                poff = pl.con_offset + pl.N * pl.nx
                lam_path = lam[poff : poff + pl.N * ph.npath].reshape(pl.N, ph.npath)
            else:
                lam_path = z.new_zeros((pl.N, 0))

            def node_lag(xi, tau_k, w_k, ldef, lpath):
                x, u, t0_, tf_, q_ = _split_node(pl, xi)
                half_ = (tf_ - t0_) / 2.0
                t = (tau_k + 1.0) * half_ + t0_
                # anchored on xi so the value is a function of the AD input
                # even when every term below is switched off
                val = xi.sum() * 0.0
                if not gauss_newton:
                    val = val - half_ * torch.dot(
                        ldef, _vector(ph.dynamics(x, u, t, q_), z, pl.nx))
                if ph.lagrange is not None:
                    val = val + sigma * half_ * w_k * _scalar(
                        ph.lagrange(x, u, t, q_), z)
                if ph.npath > 0 and not gauss_newton:
                    val = val + torch.dot(
                        lpath, _vector(ph.path(x, u, t, q_), z, ph.npath)
                    )
                return val

            xi_nodes = _phase_node_inputs(pl, X, U, t0, tf, q)
            hblocks = vmap(_hessian(node_lag, z.dtype), in_dims=(0, 0, 0, 0, 0))(
                xi_nodes, tau, w, lam_def, lam_path
            )  # (N, nbn, nbn)

            ne = 2 * pl.nx + 2 + pl.nq
            if ph.mayer is not None or ph.nevent > 0:
                eoff = pl.con_offset + pl.N * pl.nx + pl.N * pl.npath
                lam_ev = lam[eoff : eoff + pl.nevent]

                def end_lag(xe):
                    nx = pl.nx
                    x0_, t0_ = xe[:nx], xe[nx]
                    xf_, tf_ = xe[nx + 1 : 2 * nx + 1], xe[2 * nx + 1]
                    q_ = xe[2 * nx + 2 :]
                    val = xe.sum() * 0.0
                    if ph.mayer is not None:
                        val = val + sigma * _scalar(
                            ph.mayer(x0_, t0_, xf_, tf_, q_), z)
                    if ph.nevent > 0 and not gauss_newton:
                        val = val + torch.dot(
                            lam_ev,
                            _vector(ph.event(x0_, t0_, xf_, tf_, q_), z, pl.nevent),
                        )
                    return val

                hend = _hessian(end_lag, z.dtype)(_endpoint_vector(X, t0, tf, q))
            else:
                hend = z.new_zeros((ne, ne))
            phase_h.append(PhaseHessBlocks(hblocks=hblocks, hend=hend))
            starts.append((X[0], t0, q))
            ends.append((X[-1], tf, q))

        link_h = []
        for link, loff in zip(problem.linkages, layout.link_offsets):
            if link.nlink == 0:
                link_h.append(z.new_zeros((0, 0)))
                continue
            pll, plr = layout.phases[link.left], layout.phases[link.right]
            xfl, tfl, ql = ends[link.left]
            x0r, t0r, qr = starts[link.right]
            nxl, nql, nxr = pll.nx, pll.nq, plr.nx
            lam_l = lam[loff : loff + link.nlink]

            def link_lag(v):
                return torch.dot(
                    lam_l,
                    _vector(
                        link.fn(v[:nxl], v[nxl : nxl + nql],
                                v[nxl + nql : nxl + nql + nxr],
                                v[nxl + nql + nxr :]),
                        z, link.nlink,
                    ),
                )

            v = torch.cat([xfl, ql, x0r, qr])
            if gauss_newton:   # linkage rows are constraints: no curvature
                link_h.append(z.new_zeros((v.shape[0], v.shape[0])))
            else:
                link_h.append(_hessian(link_lag, z.dtype)(v))
        return phase_h, link_h

    return hess_blocks


def _flat_blocks(pieces):
    return torch.cat([p.reshape(-1) for p in pieces])


def make_structured_jacobian_mesh(problem: Problem, layout: Layout) -> Callable:
    """Return ``jac(z, mesh) -> (m, n)`` assembled from per-node blocks;
    ``mesh`` is the per-phase ``(tau, tau_state, w, D)`` tuple (see
    ``transcribe.const_mesh``)."""
    n, m = layout.nvar, layout.ncon

    # constant skeleton: the linear (duration / time-link) rows. The
    # kron(D, I_nx) defect skeleton is mesh-dependent and joins the gathered
    # sources below.
    skeleton = np.zeros((m, n))
    row = layout.linear_offset
    for pl in layout.phases:
        skeleton[row, pl.tf_index] = 1.0
        skeleton[row, pl.t0_index] = -1.0
        row += 1
    for link in problem.linkages:
        skeleton[row, layout.phases[link.right].t0_index] = 1.0
        skeleton[row, layout.phases[link.left].tf_index] = -1.0
        row += 1

    # destination (flat row*n + col) of every source entry, in the order
    # the sources are concatenated in ``jac`` below
    dest = []
    for pl in layout.phases:
        nidx = _node_indices(pl)
        eidx = _endpoint_indices(pl)
        if pl.nx:
            r = pl.con_offset + np.arange(pl.N * pl.nx)[:, None]
            c = pl.var_offset + np.arange(pl.npts * pl.nx)[None, :]
            dest.append((r * n + c).reshape(-1))
        rows = (
            pl.con_offset
            + np.arange(pl.N)[:, None, None] * pl.nx
            + np.arange(pl.nx)[None, :, None]
        )
        dest.append((rows * n + nidx[:, None, :]).reshape(-1))
        if pl.npath > 0:
            poff = pl.con_offset + pl.N * pl.nx
            prow = (
                poff
                + np.arange(pl.N)[:, None, None] * pl.npath
                + np.arange(pl.npath)[None, :, None]
            )
            dest.append((prow * n + nidx[:, None, :]).reshape(-1))
        if pl.nevent > 0:
            eoff = pl.con_offset + pl.N * pl.nx + pl.N * pl.npath
            erow = eoff + np.arange(pl.nevent)[:, None]
            dest.append((erow * n + eidx[None, :]).reshape(-1))
    for link, loff in zip(problem.linkages, layout.link_offsets):
        if link.nlink == 0:
            continue
        lrow = loff + np.arange(link.nlink)[:, None]
        dest.append((lrow * n + _link_indices(layout, link)[None, :]).reshape(-1))
    assembly = _GatherAssembly(
        np.concatenate(dest) if dest else np.zeros(0, np.int64), m * n
    )
    jac_blocks = make_jac_blocks(problem, layout)
    skeletons = {}

    def jac(z, mesh):
        key = (str(z.device), z.dtype)
        if key not in skeletons:
            skeletons[key] = torch.as_tensor(skeleton, device=z.device, dtype=z.dtype)
        phase_blocks, link_blocks = jac_blocks(z, mesh)
        src = []
        for pl, (_, _, _, D), pb in zip(layout.phases, mesh, phase_blocks):
            if pl.nx:
                src.append(torch.kron(D, torch.eye(pl.nx, dtype=z.dtype, device=z.device)))
            src.append(pb.dblocks)
            if pl.npath > 0:
                src.append(pb.pblocks)
            if pl.nevent > 0:
                src.append(pb.eblock)
        for link, lblock in zip(problem.linkages, link_blocks):
            if link.nlink > 0:
                src.append(lblock)
        if not src:
            return skeletons[key]
        return skeletons[key] + assembly(_flat_blocks(src)).reshape(m, n)

    return jac


def make_structured_jacobian(
    problem: Problem, layout: Layout, ops: Sequence[SegmentOps],
    *, device=None, dtype=torch.float64,
) -> Callable:
    """``jac(z) -> (m, n)`` on a fixed mesh (operators baked as constants)."""
    jac_m = make_structured_jacobian_mesh(problem, layout)
    mesh = const_mesh(ops, device=device, dtype=dtype)
    return lambda z: jac_m(z, mesh)


def make_structured_hessian_mesh(
    problem: Problem, layout: Layout, gauss_newton: bool = False
) -> Callable:
    """Return ``hess(z, lam, mesh, sigma=1.0) -> (n, n)``: the Lagrangian
    Hessian ``∇²[σ f(z) + λᵀ c(z)]`` assembled from per-node blocks
    (objective-only Gauss-Newton blocks with ``gauss_newton``)."""
    n = layout.nvar
    dest = []
    for pl in layout.phases:
        nidx = _node_indices(pl)
        eidx = _endpoint_indices(pl)
        dest.append((nidx[:, :, None] * n + nidx[:, None, :]).reshape(-1))
        dest.append((eidx[:, None] * n + eidx[None, :]).reshape(-1))
    for link in problem.linkages:
        if link.nlink == 0:
            continue
        lidx = _link_indices(layout, link)
        dest.append((lidx[:, None] * n + lidx[None, :]).reshape(-1))
    assembly = _GatherAssembly(
        np.concatenate(dest) if dest else np.zeros(0, np.int64), n * n
    )
    hess_blocks = make_hess_blocks(problem, layout, gauss_newton)

    def hess(z, lam, mesh, sigma=1.0):
        phase_h, link_h = hess_blocks(z, lam, mesh, sigma)
        src = []
        for phb in phase_h:
            src.append(phb.hblocks)
            src.append(phb.hend)
        for link, hl in zip(problem.linkages, link_h):
            if link.nlink > 0:
                src.append(hl)
        if not src:
            return z.new_zeros((n, n))
        return assembly(_flat_blocks(src)).reshape(n, n)

    return hess


def make_structured_hessian(
    problem: Problem, layout: Layout, ops: Sequence[SegmentOps],
    gauss_newton: bool = False, *, device=None, dtype=torch.float64,
) -> Callable:
    """``hess(z, lam, sigma=1.0) -> (n, n)`` on a fixed mesh."""
    hess_m = make_structured_hessian_mesh(problem, layout, gauss_newton)
    mesh = const_mesh(ops, device=device, dtype=dtype)
    return lambda z, lam, sigma=1.0: hess_m(z, lam, mesh, sigma)
