"""Matrix-free structured KKT: block matvecs + direct block assembly.

The dense structured path assembles per-node derivative blocks into DENSE
(m, n) / (n, n) matrices, and the block factorizer of :mod:`.block_kkt` can
gather its segment blocks back out of the dense condensed ``K`` — O(n²)
memory and assembly on every iteration. This module removes the dense
intermediates (the capability match for the reference's sparse-triplet
assembly + MUMPS, which never forms dense matrices —
``LpNLPWrapper.cpp:230-862``, ``LpNLPSolver.cpp``):

* ``jv``/``jtv``/``hv`` — Jacobian / transposed-Jacobian / Lagrangian-Hessian
  matvecs computed directly from the per-node blocks of
  :mod:`.structured` (einsum + static-index scatter; O(N) memory),
* ``assemble`` — the condensed KKT ``K = H + Σ + δI + Jᵀ D J`` built
  **per segment** into the ``(A, B, C)`` block form of
  :mod:`.block_kkt` (interior blocks, border coupling, border block):
  each segment's local Jacobian (defect + path rows over its support)
  and node Hessians land in a local ``(bl, bl)`` stiffness via static index
  maps, then split into interior/border parts — O(S·b²) memory total.

Under a segment-sharding policy (:mod:`..parallel.segment`) ``assemble``
builds the per-segment tensors (``Jloc``/``Kloc``) and blocks of this rank's
share of the segments only, pads the share with identity blocks, and gives
the border block as this rank's partial (the border's own terms on the lead
rank); :func:`.block_kkt.factor_from_blocks` sums it over the ranks.

Counterpart of the JAX package's ``core/kkt_blocks.py``. Every closure
takes and returns tensors with a leading instance axis (B); the per-node
blocks come from the single-instance functions of :mod:`.structured` lifted
with ``torch.func.vmap``. The mesh operators and scale vectors are shared
by the batch: :func:`bind_structured_kkt` holds them, without an instance
axis, and hands them to the closures, so the block trees the IPM carries
hold batched tensors only. Each ``.at[...].add`` scatter of the JAX
module is an ``index_put_(..., accumulate=True)`` here, which on the CPU
adds repeated indices in the order of the updates, as XLA's scatter does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..parallel.segment import seg_is_lead, seg_lead, seg_share
from .block_kkt import BlockKKTSpec, factor_from_blocks, make_block_factorizer
from .problem import Problem
from .structured import (
    _endpoint_indices,
    _link_indices,
    _node_indices,
    make_hess_blocks,
    make_jac_blocks,
)
from .transcribe import Layout


class _PhaseMaps(NamedTuple):
    """Static per-phase index maps (numpy; tensors per device on use)."""

    node_of: np.ndarray      # (S, degmax) node index (0-padded)
    node_mask: np.ndarray    # (S, degmax) bool
    xpt_of: np.ndarray       # (S, degmax+1) X support-point index (0-padded)
    xpt_mask: np.ndarray     # (S, degmax+1) bool
    nloc: np.ndarray         # (S, degmax, nbn) local col of node inputs
    xpt_loc: np.ndarray      # (S, degmax+1) local col base of X support point
    drow_glob: np.ndarray    # (S, degmax, nx) global constraint row of defects
    prow_glob: np.ndarray    # (S, degmax, npath) global row of path rows
    border_pos: np.ndarray   # (S, lbmax) border position of local border slots
    border_mask: np.ndarray  # (S, lbmax) bool
    epos: np.ndarray         # (ne,) border positions of [x0, t0, xf, tf, q]
    erow_glob: np.ndarray    # (nevent,) global rows of event constraints
    seg_off: int             # first global segment index of this phase
    nseg: int


class Shared(NamedTuple):
    """The operators shared by the whole batch (no instance axis)."""

    D: list                # per phase: (N, npts) differentiation matrix
    sc: torch.Tensor       # (m,) constraint scales
    vinv: torch.Tensor     # (n,) inverse variable scales


class StructuredKKT(NamedTuple):
    """Mesh/scale-parametric closures; :func:`bind_structured_kkt` produces
    the IPM-facing object with mesh + scaling bound."""

    jac_blocks: Callable   # (z_raw, mesh) -> jblocks dict
    hess_blocks: Callable  # (z_raw, lam_scaled, mesh, sf, sc) -> hblocks dict
    jv: Callable           # (jblocks, v_scaledspace, shared) -> (B, m) scaled rows
    jtv: Callable          # (jblocks, u, shared) -> (B, n)
    hv: Callable           # (hblocks, v, shared) -> (B, n)
    assemble: Callable     # (jblocks, hblocks, d, wdiag, shared) -> (A, B, C)
    factorize: Callable    # (jblocks, hblocks, d, wdiag, shared) -> BlockFactor
    fsolve: Callable       # (F, r) -> K^{-1} r
    factor_ok: Callable    # F -> (B,) bool


class BoundKKT(NamedTuple):
    """What the IPM consumes: everything bound except the evaluation point."""

    jac_blocks: Callable   # z_scaled -> jblocks
    hess_blocks: Callable  # (z_scaled, lam_scaledspace) -> hblocks
    jv: Callable           # (jblocks, v) -> (B, m)
    jtv: Callable          # (jblocks, u) -> (B, n)
    hv: Callable           # (hblocks, v) -> (B, n)
    factorize: Callable    # (jblocks, hblocks, d, wdiag) -> F
    fsolve: Callable
    factor_ok: Callable
    # (jblocks, hblocks, d, wdiag) -> (A, B, C): the blocks factorize factors
    # (the IPM calls factorize only)
    assemble: Callable | None = None


def _build_phase_maps(problem: Problem, layout: Layout, spec: BlockKKTSpec):
    """Numpy index maps per phase, consistent with make_block_spec's ordering
    (interior: x inner points raveled then controls; border per phase:
    separator x's, then [t0, tf], then q)."""
    bmax = spec.block_size
    maps = []
    seg_off = 0
    border_off = 0
    lbmax = max(2 * pl.nx + 2 + pl.nq for pl in layout.phases)
    degmax_all = 0
    for ph, pl in zip(problem.phases, layout.phases):
        degrees = list(ph.mesh_degrees)
        degmax_all = max(degmax_all, max(degrees))
    for ph, pl in zip(problem.phases, layout.phases):
        degrees = list(ph.mesh_degrees)
        S = len(degrees)
        nx, nu, nq, npath = pl.nx, pl.nu, pl.nq, pl.npath
        degmax = degmax_all
        nbn = nx + nu + 2 + nq
        seg_starts = np.concatenate([[0], np.cumsum(degrees)])[:-1].astype(int)
        node_of = np.zeros((S, degmax), np.int32)
        node_mask = np.zeros((S, degmax), bool)
        xpt_of = np.zeros((S, degmax + 1), np.int32)
        xpt_mask = np.zeros((S, degmax + 1), bool)
        nloc = np.zeros((S, degmax, nbn), np.int32)
        xpt_loc = np.zeros((S, degmax + 1), np.int32)
        drow_glob = np.zeros((S, degmax, nx), np.int32)
        prow_glob = np.zeros((S, degmax, max(npath, 0)), np.int32)
        border_pos = np.zeros((S, lbmax), np.int32)
        border_mask = np.zeros((S, lbmax), bool)
        # border layout of this phase within spec.border_idx
        # (x at S+1 separator points, then t0, tf, then q)
        xsep_base = border_off
        t0_pos = border_off + (S + 1) * nx
        tf_pos = t0_pos + 1
        q_base = tf_pos + 1
        for s, deg in enumerate(degrees):
            start = int(seg_starts[s])
            node_of[s, :deg] = start + np.arange(deg)
            node_mask[s, :deg] = True
            xpt_of[s, : deg + 1] = start + np.arange(deg + 1)
            xpt_mask[s, : deg + 1] = True
            # local border slots: [x_start (nx), x_end (nx), t0, tf, q]
            lb_x_start = bmax
            lb_x_end = bmax + nx
            lb_t0 = bmax + 2 * nx
            lb_tf = lb_t0 + 1
            lb_q = lb_tf + 1
            # local col of X support point k
            for k in range(deg + 1):
                if k == 0:
                    xpt_loc[s, k] = lb_x_start
                elif k == deg:
                    xpt_loc[s, k] = lb_x_end
                else:
                    xpt_loc[s, k] = (k - 1) * nx
            bx = (deg - 1) * nx
            for j in range(deg):
                cols = []
                if j == 0:
                    cols.extend(lb_x_start + np.arange(nx))
                else:
                    cols.extend((j - 1) * nx + np.arange(nx))
                cols.extend(bx + j * nu + np.arange(nu))
                cols.append(lb_t0)
                cols.append(lb_tf)
                cols.extend(lb_q + np.arange(nq))
                nloc[s, j] = cols
                drow_glob[s, j] = pl.con_offset + (start + j) * nx + np.arange(nx)
                if npath:
                    prow_glob[s, j] = (
                        pl.con_offset + pl.N * nx + (start + j) * npath
                        + np.arange(npath)
                    )
            # border positions of the local border slots
            bp = []
            bp.extend(xsep_base + s * nx + np.arange(nx))         # x_start
            bp.extend(xsep_base + (s + 1) * nx + np.arange(nx))   # x_end
            bp.append(t0_pos)
            bp.append(tf_pos)
            bp.extend(q_base + np.arange(nq))
            border_pos[s, : len(bp)] = bp
            border_mask[s, : len(bp)] = True
        epos = np.concatenate([
            xsep_base + np.arange(nx),                 # x0 = x at separator 0
            [t0_pos],
            xsep_base + S * nx + np.arange(nx),        # xf = x at separator S
            [tf_pos],
            q_base + np.arange(nq),
        ]).astype(np.int32)
        eoff = pl.con_offset + pl.N * (nx + npath)
        erow_glob = (eoff + np.arange(pl.nevent)).astype(np.int32)
        maps.append(_PhaseMaps(
            node_of=node_of, node_mask=node_mask,
            xpt_of=xpt_of, xpt_mask=xpt_mask,
            nloc=nloc, xpt_loc=xpt_loc,
            drow_glob=drow_glob, prow_glob=prow_glob,
            border_pos=border_pos, border_mask=border_mask,
            epos=epos, erow_glob=erow_glob, seg_off=seg_off, nseg=S,
        ))
        seg_off += S
        border_off = q_base + nq
    assert seg_off == spec.num_blocks
    assert border_off == spec.border_size
    return maps, lbmax


def _link_border_pos(problem, layout, maps):
    """Border positions of each linkage's inputs [xf_l, q_l, x0_r, q_r]."""
    out = []
    for link in problem.linkages:
        ml, mr = maps[link.left], maps[link.right]
        pll, plr = layout.phases[link.left], layout.phases[link.right]
        nxl, nql = pll.nx, pll.nq
        # epos layout: [x0 (nx), t0, xf (nx), tf, q (nq)]
        xf_l = ml.epos[nxl + 1 : 2 * nxl + 1]
        q_l = ml.epos[2 * nxl + 2 :]
        x0_r = mr.epos[: plr.nx]
        q_r = mr.epos[2 * plr.nx + 2 :]
        out.append(np.concatenate([xf_l, q_l, x0_r, q_r]).astype(np.int32))
    return out


def _local_maps(mp: _PhaseMaps, lo: int, hi: int) -> _PhaseMaps:
    """``mp`` cut to the global segments ``[lo, hi)`` (this rank's share)."""
    a = min(max(lo - mp.seg_off, 0), mp.nseg)
    b = min(max(hi - mp.seg_off, 0), mp.nseg)
    per_seg = {f: getattr(mp, f)[a:b] for f in _PhaseMaps._fields
               if f not in ("epos", "erow_glob", "seg_off", "nseg")}
    return mp._replace(**per_seg, seg_off=mp.seg_off + a, nseg=b - a)


def _as_tensor(a, device):
    """Index maps as int64 (masks stay bool); python ints pass through."""
    if not isinstance(a, np.ndarray):
        return a
    if a.dtype == bool:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.int64), device=device)


def _scatter_add(out, index, values):
    """In-place ``out[index] += values`` with repeated indices summed (the
    JAX ``.at[index].add``)."""
    return out.index_put_(index, values, accumulate=True)


def make_structured_kkt(
    problem: Problem, layout: Layout, spec: BlockKKTSpec,
    gauss_newton: bool = False,
) -> StructuredKKT:
    """Build the matrix-free structured-KKT closures for this layout/spec."""
    n = layout.nvar
    maps, lbmax = _build_phase_maps(problem, layout, spec)
    bmax = spec.block_size
    nb = spec.border_size
    jac_blocks_raw = vmap(make_jac_blocks(problem, layout), in_dims=(0, None))
    hess_blocks_raw = vmap(make_hess_blocks(problem, layout, gauss_newton),
                           in_dims=(0, 0, None, None))
    _, block_fsolve, block_fok = make_block_factorizer(spec)

    # static: linear rows' border Jacobian (±1 at t0/tf border positions)
    n_lin = len(problem.phases) + len(problem.linkages)
    Jlin = np.zeros((n_lin, nb))
    r = 0
    for p, (ph, mp) in enumerate(zip(problem.phases, maps)):
        t0_pos = int(mp.epos[layout.phases[p].nx])
        tf_pos = int(mp.epos[2 * layout.phases[p].nx + 1])
        Jlin[r, tf_pos] = 1.0
        Jlin[r, t0_pos] = -1.0
        r += 1
    for link in problem.linkages:
        mpl, mpr = maps[link.left], maps[link.right]
        tfl_pos = int(mpl.epos[2 * layout.phases[link.left].nx + 1])
        t0r_pos = int(mpr.epos[layout.phases[link.right].nx])
        Jlin[r, t0r_pos] = 1.0
        Jlin[r, tfl_pos] = -1.0
        r += 1

    # per-phase linear-row variable indices for jv/jtv
    lin_var = np.zeros((n_lin, 2), np.int32)   # (+1 idx, -1 idx)
    r = 0
    for pl in layout.phases:
        lin_var[r] = (pl.tf_index, pl.t0_index)
        r += 1
    for link in problem.linkages:
        lin_var[r] = (
            layout.phases[link.right].t0_index, layout.phases[link.left].tf_index
        )
        r += 1

    host = {
        "node_idx": [_node_indices(pl) for pl in layout.phases],
        "end_idx": [_endpoint_indices(pl) for pl in layout.phases],
        "link_idx": [_link_indices(layout, l) for l in problem.linkages],
        "lpos": _link_border_pos(problem, layout, maps),
        "border_idx": spec.border_idx,
        "interior_idx": spec.interior_idx,
        "interior_mask": spec.interior_mask,
        "lin_var": lin_var,
        "lin_rows": np.arange(layout.linear_offset, layout.ncon),
    }
    consts = {}

    def on(device, dtype):
        """The static maps as tensors on ``device`` (made once)."""
        key = (str(device), dtype)
        if key not in consts:
            c = {k: ([_as_tensor(a, device) for a in v] if isinstance(v, list)
                     else _as_tensor(v, device)) for k, v in host.items()}
            c["maps"] = [_PhaseMaps(*(_as_tensor(a, device) for a in mp)) for mp in maps]
            c["Jlin"] = torch.as_tensor(Jlin, device=device, dtype=dtype)
            consts[key] = c
        return consts[key]

    def jac_blocks(z_raw, mesh):
        phase_blocks, link_blocks = jac_blocks_raw(z_raw, mesh)
        return {"phase": phase_blocks, "link": link_blocks}

    def hess_blocks(z_raw, lam_scaled, mesh, sf, sc):
        phase_h, link_h = hess_blocks_raw(z_raw, sc * lam_scaled, mesh, sf)
        return {"phase": phase_h, "link": link_h}

    # ----- matvecs (scaled space: J_s = S_c J V^{-1}) -----
    def jv(jb, v, sh):
        c = on(v.device, v.dtype)
        Z = v.shape[0]
        vr = sh.vinv * v
        rows = []
        for pl, pb, D, nidx, eidx in zip(
            layout.phases, jb["phase"], sh.D, c["node_idx"], c["end_idx"]
        ):
            Vx = vr[:, pl.x_slice].reshape(Z, pl.npts, pl.nx)
            vn = vr[:, nidx]                                     # (B, N, nbn)
            defect = D @ Vx + torch.einsum("znij,znj->zni", pb.dblocks, vn)
            rows.append(defect.reshape(Z, -1))
            if pl.npath:
                rows.append(torch.einsum("znij,znj->zni", pb.pblocks, vn).reshape(Z, -1))
            if pl.nevent:
                rows.append(torch.einsum("zri,zi->zr", pb.eblock, vr[:, eidx]))
        for link, lb, lidx in zip(problem.linkages, jb["link"], c["link_idx"]):
            if link.nlink:
                rows.append(torch.einsum("zri,zi->zr", lb, vr[:, lidx]))
        rows.append(vr[:, c["lin_var"][:, 0]] - vr[:, c["lin_var"][:, 1]])
        return sh.sc * torch.cat(rows, dim=1)

    def jtv(jb, u, sh):
        c = on(u.device, u.dtype)
        Z = u.shape[0]
        zi = torch.arange(Z, device=u.device)
        us = sh.sc * u
        out = u.new_zeros((Z, n))
        for pl, pb, D, nidx, eidx in zip(
            layout.phases, jb["phase"], sh.D, c["node_idx"], c["end_idx"]
        ):
            u_def = us[:, pl.con_offset : pl.con_offset + pl.N * pl.nx].reshape(
                Z, pl.N, pl.nx
            )
            out[:, pl.x_slice] += (D.T @ u_def).reshape(Z, -1)
            acc = torch.einsum("znij,zni->znj", pb.dblocks, u_def)
            if pl.npath:
                poff = pl.con_offset + pl.N * pl.nx
                u_p = us[:, poff : poff + pl.N * pl.npath].reshape(Z, pl.N, pl.npath)
                acc = acc + torch.einsum("znij,zni->znj", pb.pblocks, u_p)
            _scatter_add(out, (zi[:, None, None], nidx[None]), acc)
            if pl.nevent:
                eoff = pl.con_offset + pl.N * (pl.nx + pl.npath)
                _scatter_add(out, (zi[:, None], eidx[None]), torch.einsum(
                    "zri,zr->zi", pb.eblock, us[:, eoff : eoff + pl.nevent]))
        for link, loff, lb, lidx in zip(
            problem.linkages, layout.link_offsets, jb["link"], c["link_idx"]
        ):
            if link.nlink:
                _scatter_add(out, (zi[:, None], lidx[None]), torch.einsum(
                    "zri,zr->zi", lb, us[:, loff : loff + link.nlink]))
        u_lin = us[:, c["lin_rows"]]
        _scatter_add(out, (zi[:, None], c["lin_var"][None, :, 0]), u_lin)
        _scatter_add(out, (zi[:, None], c["lin_var"][None, :, 1]), -u_lin)
        return sh.vinv * out

    def hv(hb, v, sh):
        c = on(v.device, v.dtype)
        Z = v.shape[0]
        zi = torch.arange(Z, device=v.device)
        vr = sh.vinv * v
        out = v.new_zeros((Z, n))
        for phb, nidx, eidx in zip(hb["phase"], c["node_idx"], c["end_idx"]):
            _scatter_add(out, (zi[:, None, None], nidx[None]),
                         torch.einsum("znij,znj->zni", phb.hblocks, vr[:, nidx]))
            _scatter_add(out, (zi[:, None], eidx[None]),
                         torch.einsum("zij,zj->zi", phb.hend, vr[:, eidx]))
        for link, hl, lidx in zip(problem.linkages, hb["link"], c["link_idx"]):
            if link.nlink:
                _scatter_add(out, (zi[:, None], lidx[None]),
                             torch.einsum("zij,zj->zi", hl, vr[:, lidx]))
        return sh.vinv * out

    # ----- direct block assembly -----
    bl = bmax + lbmax

    def assemble(jb, hb, d, wdiag, sh):
        sc, vinv = sh.sc, sh.vinv
        dtype, dev = d.dtype, d.device
        c = on(dev, dtype)
        Z = d.shape[0]
        zi = torch.arange(Z, device=dev)
        zi5 = zi[:, None, None, None, None]
        zi4 = zi[:, None, None, None]
        zi3 = zi[:, None, None]
        A_parts, B_parts = [], []
        lo, hi, slots = seg_share(spec.num_blocks)
        lead = seg_is_lead()
        C = seg_lead(torch.diag_embed(wdiag[:, c["border_idx"]]))
        for pl, mp, pb, phb, D, nidx, eidx in zip(
            layout.phases, c["maps"], jb["phase"], hb["phase"], sh.D,
            c["node_idx"], c["end_idx"]
        ):
            if (lo, hi) != (0, spec.num_blocks):
                mp = _local_maps(mp, lo, hi)
            S, degmax = mp.node_of.shape
            nx, npath = pl.nx, pl.npath
            ar = lambda k: torch.arange(k, device=dev)
            nmask = mp.node_mask.to(dtype)
            # scaled per-node blocks gathered per segment
            vinv_n = vinv[nidx]                                     # (N, nbn)
            sc_def = sc[pl.con_offset : pl.con_offset + pl.N * nx].reshape(pl.N, nx)
            db_s = pb.dblocks * sc_def[:, :, None] * vinv_n[:, None, :]
            db = db_s[:, mp.node_of] * nmask[:, :, None, None]      # (B, S, degmax, nx, nbn)
            hb_s = phb.hblocks * vinv_n[:, :, None] * vinv_n[:, None, :]
            hbg = hb_s[:, mp.node_of] * nmask[:, :, None, None]
            # scaled D values over support (shared by the batch)
            vinv_x = vinv[pl.x_slice].reshape(pl.npts, nx)
            dvals = D[mp.node_of[:, :, None], mp.xpt_of[:, None, :]]
            dvals = dvals * nmask[:, :, None] * mp.xpt_mask.to(dtype)[:, None, :]
            # (S, degmax, degmax+1, nx): row scale (node,i), col scale (pt,i)
            dv = (
                dvals[:, :, :, None]
                * sc_def[mp.node_of][:, :, None, :]
                * vinv_x[mp.xpt_of][:, None, :, :]
            )
            sidx = ar(S)[:, None, None, None]
            # per-segment local stiffness assembly
            Jloc = torch.zeros((S, degmax * (nx + npath), bl), dtype=dtype, device=dev)
            rowsD = ar(degmax)[None, :, None, None] * nx + ar(nx)[None, None, None, :]
            colsD = mp.xpt_loc[:, None, :, None] + ar(nx)[None, None, None, :]
            _scatter_add(Jloc, (sidx, rowsD, colsD), dv)
            Jloc = Jloc.expand(Z, *Jloc.shape).contiguous()
            rowsN = ar(degmax)[None, :, None, None] * nx + ar(nx)[None, None, :, None]
            colsN = mp.nloc[:, :, None, :]
            _scatter_add(Jloc, (zi5, sidx[None], rowsN[None], colsN[None]), db)
            dloc_def = (d[:, mp.drow_glob] * nmask[:, :, None]).reshape(Z, S, degmax * nx)
            if npath:
                pb_s = pb.pblocks * sc[
                    pl.con_offset + pl.N * nx : pl.con_offset + pl.N * (nx + npath)
                ].reshape(pl.N, npath)[:, :, None] * vinv_n[:, None, :]
                pbg = pb_s[:, mp.node_of] * nmask[:, :, None, None]
                rowsP = (
                    degmax * nx
                    + ar(degmax)[None, :, None, None] * npath
                    + ar(npath)[None, None, :, None]
                )
                _scatter_add(Jloc, (zi5, sidx[None], rowsP[None], colsN[None]), pbg)
                dloc_p = (d[:, mp.prow_glob] * nmask[:, :, None]).reshape(
                    Z, S, degmax * npath
                )
                dloc = torch.cat([dloc_def, dloc_p], dim=2)
            else:
                dloc = dloc_def
            Kloc = (Jloc * dloc[..., None]).transpose(-1, -2) @ Jloc   # (B, S, bl, bl)
            _scatter_add(Kloc, (zi5, sidx[None], mp.nloc[None, :, :, :, None],
                                mp.nloc[None, :, :, None, :]), hbg)
            # interior part + Sigma diag + pad identity
            A_p = Kloc[:, :, :bmax, :bmax]
            imask = c["interior_mask"][mp.seg_off : mp.seg_off + S]
            iidx = c["interior_idx"][mp.seg_off : mp.seg_off + S]
            one = torch.ones((), dtype=dtype, device=dev)
            A_parts.append(A_p + torch.diag_embed(torch.where(imask, wdiag[:, iidx], one)))
            # border coupling
            bm = mp.border_mask.to(dtype)
            BL = Kloc[:, :, bmax:, :bmax]                           # (B, S, lbmax, bmax)
            B_p = torch.zeros((Z, S, nb, bmax), dtype=dtype, device=dev)
            _scatter_add(B_p, (zi4, ar(S)[None, :, None, None],
                               mp.border_pos[None, :, :, None], ar(bmax)[None, None, None, :]),
                         BL * bm[:, :, None])
            B_parts.append(B_p)
            CL = Kloc[:, :, bmax:, bmax:]
            _scatter_add(C, (zi4, mp.border_pos[None, :, :, None],
                             mp.border_pos[None, :, None, :]),
                         CL * bm[:, :, None] * bm[:, None, :])
            if not lead:
                continue
            # endpoint Hessian + event rows (border-only; the lead rank's)
            epos_r, epos_c = mp.epos[None, :, None], mp.epos[None, None, :]
            hend_s = phb.hend * vinv[eidx][:, None] * vinv[eidx][None, :]
            _scatter_add(C, (zi3, epos_r, epos_c), hend_s)
            if pl.nevent:
                sc_ev = sc[mp.erow_glob]
                eb_s = pb.eblock * sc_ev[:, None] * vinv[eidx][None, :]
                d_ev = d[:, mp.erow_glob]
                _scatter_add(C, (zi3, epos_r, epos_c),
                             torch.einsum("zri,zr,zrj->zij", eb_s, d_ev, eb_s))
        if slots > hi - lo:
            # pad this rank's share with identity blocks and zero coupling
            pad = slots - (hi - lo)
            eye = torch.eye(bmax, dtype=dtype, device=dev)
            A_parts.append(eye.expand(Z, pad, bmax, bmax).clone())
            B_parts.append(torch.zeros((Z, pad, nb, bmax), dtype=dtype, device=dev))
        if not lead:
            return torch.cat(A_parts, dim=1), torch.cat(B_parts, dim=1), C
        # linkage rows + Hessians (border-only)
        for link, loff, lb_, hl, lidx, lpos in zip(
            problem.linkages, layout.link_offsets, jb["link"], hb["link"],
            c["link_idx"], c["lpos"]
        ):
            if link.nlink == 0:
                continue
            sc_l = sc[loff : loff + link.nlink]
            lb_s = lb_ * sc_l[:, None] * vinv[lidx][None, :]
            d_l = d[:, loff : loff + link.nlink]
            hl_s = hl * vinv[lidx][:, None] * vinv[lidx][None, :]
            _scatter_add(C, (zi3, lpos[None, :, None], lpos[None, None, :]),
                         torch.einsum("zri,zr,zrj->zij", lb_s, d_l, lb_s) + hl_s)
        # linear rows (border-only; static ±1 pattern, scaled)
        lin_rows = c["lin_rows"]
        Jlin_s = sc[lin_rows][:, None] * c["Jlin"] * vinv[c["border_idx"]][None, :]
        C = C + torch.einsum("ri,zr,rj->zij", Jlin_s, d[:, lin_rows], Jlin_s)
        return torch.cat(A_parts, dim=1), torch.cat(B_parts, dim=1), C

    def factorize(jbk, hbk, d, wdiag, sh):
        return factor_from_blocks(*assemble(jbk, hbk, d, wdiag, sh))

    return StructuredKKT(
        jac_blocks=jac_blocks, hess_blocks=hess_blocks,
        jv=jv, jtv=jtv, hv=hv,
        assemble=assemble, factorize=factorize,
        fsolve=block_fsolve, factor_ok=block_fok,
    )


def bind_structured_kkt(
    sk: StructuredKKT, mesh, sf, sc, vinv
) -> BoundKKT:
    """Bind mesh + scaling into the IPM-facing closures. ``z`` entering the
    bound closures is in SCALED space (z_s = v z ⇒ raw z = vinv * z_s).
    ``sc``/``vinv`` (numpy or tensors) are placed with the mesh operators;
    they and the mesh's differentiation matrices stay in these closures."""
    like = mesh[0][3]
    sh = Shared(
        D=[D for (_, _, _, D) in mesh],
        sc=torch.as_tensor(sc, device=like.device, dtype=like.dtype),
        vinv=torch.as_tensor(vinv, device=like.device, dtype=like.dtype),
    )

    def jb(z_s):
        return sk.jac_blocks(sh.vinv * z_s, mesh)

    def hbk(z_s, lam):
        return sk.hess_blocks(sh.vinv * z_s, lam, mesh, sf, sh.sc)

    return BoundKKT(
        jac_blocks=jb, hess_blocks=hbk,
        jv=lambda j, v: sk.jv(j, v, sh),
        jtv=lambda j, u: sk.jtv(j, u, sh),
        hv=lambda h, v: sk.hv(h, v, sh),
        factorize=lambda j, h, d, w: sk.factorize(j, h, d, w, sh),
        fsolve=sk.fsolve, factor_ok=sk.factor_ok,
        assemble=lambda j, h, d, w: sk.assemble(j, h, d, w, sh),
    )
