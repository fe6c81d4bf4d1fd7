"""Segment-axis sharding of ONE giant instance across ranks.

The reference's long-horizon story is serial: MUMPS exploits the banded
block sparsity of the transcribed NLP inside a single process
(``LpNLPSolver.cpp``). The block-KKT path already factors the condensed KKT
as S independent segment blocks plus a small border Schur complement
(:mod:`..core.block_kkt`, :mod:`..core.kkt_blocks`) — a depth-1
nested-dissection partitioning. This module stretches that seam across
ranks of a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/segment.py``. There GSPMD
partitions the traced solver from sharding annotations; torch has none, so
the seam is explicit code, active only inside :func:`segment_sharding`:

* each rank keeps a contiguous share of the segment axis S
  (:func:`seg_share`): :func:`seg_constrain` selects the local slice where
  the JAX package annotates, and the per-segment assembly tensors
  (``Jloc``/``Kloc``), blocks, factors and inverses exist for the local
  segments only;
* the border Schur matrix ``C − Σ_s B_s A_s⁻¹ B_sᵀ`` is a local partial sum
  plus ONE ``all_reduce(SUM)`` over the policy's group per factorization
  (:func:`seg_replicated`); the rank of group rank 0 (:func:`seg_lead`)
  carries the border's own terms (Σ, endpoint Hessians, events, linkages,
  linear rows) in its partial;
* each KKT solve takes one ``all_reduce`` for the border right-hand side
  ``r_b − Σ_s B_s y_s`` and one ``all_gather`` of the interior pieces
  (:func:`seg_gather`), so the IPM state stays replicated and every rank
  takes the same host-side decisions (the IPM's ``any()`` reads), which
  keeps the ranks' collectives in step.

S need not divide among the ranks: with ``k = ⌈S / size⌉`` rank r keeps the
segments ``[r·k, min((r+1)·k, S))`` and pads its share to k slots with
identity blocks (zero coupling, zero right-hand side), as the factorizer
already pads short blocks; the padded slots are dropped after the gather.

Outside a policy every hook returns its input itself (``seg_constrain(x) is
x``): the single-device path runs no collective and makes no extra copy.

One rank drives one GPU, and a mesh of n ranks is n processes (the JAX
package meshes the devices of one process). On the CPU the collectives run
on gloo, on GPUs on NCCL; the group is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import device_mesh, resolve_device


class _Policy(NamedTuple):
    group: object     # the process group of the segment axis
    rank: int         # this rank's position in it
    size: int


_ACTIVE: Optional[_Policy] = None


@contextlib.contextmanager
def segment_sharding(mesh, axis: str = "seg"):
    """Within this context the block-KKT code keeps only this rank's share
    of the segment axis and sums the border system over the ``axis`` group
    of ``mesh`` (a ``DeviceMesh``). Run the solver inside the context;
    outside it the hooks are free no-ops."""
    global _ACTIVE
    group = mesh.get_group(axis)
    prev = _ACTIVE
    _ACTIVE = _Policy(group, dist.get_rank(group), dist.get_world_size(group))
    try:
        yield
    finally:
        _ACTIVE = prev


def seg_active() -> bool:
    """Whether a segment-sharding policy is active."""
    return _ACTIVE is not None


def seg_share(S: int):
    """``(lo, hi, k)``: this rank keeps segments ``[lo, hi)`` of ``S``, in
    ``k`` slots (``hi - lo <= k``, the rest padding). ``(0, S, S)`` outside
    a policy."""
    if _ACTIVE is None:
        return 0, S, S
    k = -(-S // _ACTIVE.size)
    lo = min(_ACTIVE.rank * k, S)
    return lo, min(lo + k, S), k


def seg_constrain(x, dim: int = 0):
    """This rank's share of the segment axis ``dim`` of ``x`` (a tensor or a
    numpy array whose axis ``dim`` runs over all S segments), zero-padded to
    the share's ``k`` slots. ``x`` itself when no policy is active.

    Zero padding is what the callers need: index maps pad with index 0 and
    mask False, which the block factorizer turns into identity blocks with
    zero coupling."""
    if _ACTIVE is None:
        return x
    S = x.shape[dim]
    lo, hi, k = seg_share(S)
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(lo, hi)
    part = x[tuple(idx)]
    if hi - lo == k:
        return part
    pad_shape = list(x.shape)
    pad_shape[dim] = k - (hi - lo)
    if isinstance(x, np.ndarray):
        return np.concatenate([part, np.zeros(pad_shape, x.dtype)], axis=dim)
    return torch.cat([part, x.new_zeros(pad_shape)], dim=dim)


def seg_replicated(x):
    """Sum ``x``, this rank's partial of a border-system tensor, over the
    segment group, in place: every rank then holds the whole (replicated)
    tensor. The explicit form of the all-reduce GSPMD inserts before the
    JAX package's replicated constraint. ``x`` itself outside a policy."""
    if _ACTIVE is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_ACTIVE.group)
    return x


def seg_lead(x):
    """``x`` on the rank that carries the border's own terms in its partial
    (group rank 0, and always outside a policy), zeros on the others, so
    that :func:`seg_replicated` counts them once."""
    if _ACTIVE is None or _ACTIVE.rank == 0:
        return x
    return torch.zeros_like(x)


def seg_is_lead() -> bool:
    """Whether this rank carries the border's own terms (see :func:`seg_lead`)."""
    return _ACTIVE is None or _ACTIVE.rank == 0


def seg_gather(x, S: int, dim: int = 1):
    """All ranks' shares of a tensor whose axis ``dim`` holds this rank's
    ``k`` segment slots, concatenated in rank order with the padding
    dropped: the tensor over all ``S`` segments. ``x`` itself outside a
    policy."""
    if _ACTIVE is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_ACTIVE.size)]
    dist.all_gather(parts, x, group=_ACTIVE.group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, S)


def segment_mesh(n_devices: int = None, axis: str = "seg", devices=None, *,
                 device=None):
    """1-D ``DeviceMesh`` named ``axis`` over the ranks ``devices`` (default:
    every rank of the default process group), cut to the first
    ``n_devices``. Every rank of the default group calls it. ``device``
    (``None`` means ``"cuda"``, and raises without one) picks the mesh's
    device type."""
    device = resolve_device(device)   # before any process-group call
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return device_mesh(device, ranks, (axis,))


def make_segment_solver(
    problem,
    options=None,
    mesh=None,
    axis: str = "seg",
    *,
    device=None,
    dtype=torch.float64,
) -> Callable:
    """A SINGLE-instance IPM solve with the KKT segment axis sharded over
    the ``axis`` ranks of ``mesh`` (default :func:`segment_mesh`).

    Returns ``run() -> IPMResult`` (fields without an instance axis)
    solving the problem's transcribed NLP from its nominal guess/bounds.
    The factorization work — the per-segment condensed-KKT assembly and the
    O(S·b³) block Cholesky/inverses — splits across the ranks; the border
    Schur system and the IPM state vector stay replicated. Every rank of
    the mesh calls ``run()`` together and gets the same result.

    Use for single giant instances (fine meshes, thousands of collocation
    points) where one GPU's memory or FLOPs are the limit; for sweeps of
    many small instances use :func:`..parallel.batch.make_batch_solver`.
    ``device=None`` means ``"cuda"``.
    """
    from ..core.ipm import build_solver
    from ..core.solve import SolveOptions, _bind_fixed_mesh, _kkt_structured
    from ..core.scaling import scale_nlp
    from ..core.transcribe import transcribe

    device = resolve_device(device)
    options = options or SolveOptions()
    if options.block_kkt == "auto":
        # sharding lives on the block path: engage it regardless of size
        options = dataclasses.replace(options, block_kkt="on")
    mesh = mesh if mesh is not None else segment_mesh(axis=axis, device=device)
    nlp = transcribe(problem, device=device, dtype=dtype)
    scaled = scale_nlp(
        nlp.objective, nlp.constraints, nlp.zl, nlp.zu, nlp.cl, nlp.cu, nlp.z0,
        enabled=options.auto_scale, variable_scaling=options.variable_scaling,
        samples=options.scale_samples, device=device, dtype=dtype,
    )
    sk = _kkt_structured(problem, nlp, options)
    if sk is None:
        raise ValueError(
            "segment sharding requires the structured block-KKT path "
            "(options.block_kkt='on'/'auto' with >1 segment)"
        )
    solver = build_solver(
        scaled.objective, scaled.constraints, nlp.n, nlp.m,
        options.ipm_options(),
        structured_kkt=_bind_fixed_mesh(sk, nlp, scaled, device, dtype),
    )
    args = tuple(
        torch.as_tensor(np.asarray(a), device=device, dtype=dtype)[None]
        for a in (scaled.z0, scaled.zl, scaled.zu, scaled.cl, scaled.cu)
    )

    def run():
        with segment_sharding(mesh, axis):
            res = solver(*args)
        return type(res)(*(None if f is None else
                           {k: v[0] for k, v in f.items()} if isinstance(f, dict)
                           else f[0] for f in res))

    run.nlp = nlp
    run.scaled = scaled
    run.mesh = mesh
    run.solver = solver
    run.args = args
    return run
