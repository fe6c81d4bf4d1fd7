"""Hybrid 2-D sharding: instance axis × segment axis on one rank mesh.

The two scale-out stories compose:

* :mod:`.batch` (``mesh=``) splits a sweep of SMALL instances over every
  rank — pure data parallelism, no collective in the solve;
* :mod:`.segment` splits ONE giant instance's block-KKT segment axis over
  ranks — each factorization runs one ``all_reduce`` for the border Schur
  assembly, each solve one for the border right-hand side and one
  ``all_gather`` of the interior pieces.

This module runs a *batch of giant instances* on a 2-D ``("dp", "seg")``
``DeviceMesh``: the instance axis splits over ``dp`` and every instance's
KKT segment tensors over ``seg``. Each ``dp`` row solves its contiguous
slice of the instances with the segment-sharded block solver over its own
``seg`` subgroup (``mesh.get_group("seg")``), with the instance axis the
block path already has; one ``all_gather`` over ``dp`` per result field
then gives every rank the full result. On a multi-host cluster
:func:`hybrid_mesh` puts each ``dp`` row on one host, so the per-iteration
segment collectives stay on the host's NVLink and the instance axis, which
carries no solver traffic, spans the hosts.

Counterpart of the JAX package's ``parallel/hybrid.py``, where the same
layout is one ``jax.vmap(solver, spmd_axis_name="dp")`` partitioned by
GSPMD. One rank drives one GPU, and a mesh of n ranks is n processes (the
JAX package meshes the devices of its processes); every rank of the mesh
calls ``run`` together.

The reference has no analog (single process, one instance at a time).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.problem import Problem
from ..core.solve import SolveOptions
from ..utils.device import device_mesh, resolve_device
from .batch import _gather_rows
from .segment import segment_sharding


def hybrid_mesh(
    n_dp: Optional[int] = None,
    n_seg: Optional[int] = None,
    devices=None,
    *,
    device=None,
):
    """2-D ``("dp", "seg")`` ``DeviceMesh`` with host-aligned rows.

    ``devices`` are ranks (default: every rank of the default process
    group). Defaults: ``seg`` = the ranks per host (``LOCAL_WORLD_SIZE``,
    which ``torchrun`` sets; all ranks when it is unset), ``dp`` = the
    number of such rows. Row i holds the consecutive ranks
    ``i·n_seg … (i+1)·n_seg − 1``, which is one host under ``torchrun``'s
    numbering: segment collectives stay within a host, the instance axis
    spans hosts. ``device`` (``None`` means ``"cuda"``) picks the mesh's
    device type.
    """
    device = resolve_device(device)   # before any process-group call
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if n_seg is None and n_dp is None:
        n_seg = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
        if len(ranks) % n_seg:
            n_seg = len(ranks)
    if n_seg is None:
        n_seg = len(ranks) // n_dp
    if n_dp is None:
        n_dp = len(ranks) // n_seg
    grid = np.asarray(ranks[: n_dp * n_seg]).reshape(n_dp, n_seg)
    return device_mesh(device, grid.tolist(), ("dp", "seg"))


@dataclass
class HybridBatchSolver:
    """Batch-of-giant-instances solver on a ``("dp", "seg")`` mesh.

    ``run`` takes globally-shaped batched arrays (leading axis = instance,
    split over ``dp``) and returns the whole batched result on every rank;
    :meth:`run_local` takes and returns this rank's ``dp`` row's shard
    (same convention as :class:`.distributed.DistributedBatchSolver`).
    """

    problem: Problem
    nlp: object
    scaled: object
    run: Callable
    mesh: object
    n: int
    m: int
    solve_row: Callable = None   # one dp row's instances through the segment-sharded solver

    def nominal_inputs(self, batch: int):
        s = self.scaled
        tile = lambda a: np.broadcast_to(
            np.asarray(a), (batch,) + np.asarray(a).shape
        ).copy()
        return (tile(s.z0), tile(s.zl), tile(s.zu), tile(s.cl), tile(s.cu))

    # -- per-row local-shard IO ----------------------------------------------
    def local_batch_size(self, global_batch: int) -> int:
        n_dp = self.mesh.size(self.mesh.mesh_dim_names.index("dp"))
        assert global_batch % n_dp == 0, (
            f"global batch {global_batch} must divide the dp axis {n_dp}"
        )
        # one rank lies in exactly one dp row
        return global_batch // n_dp

    def nominal_local_inputs(self, global_batch: int):
        return self.nominal_inputs(self.local_batch_size(global_batch))

    def run_local(self, z0, zl, zu, cl, cu, lam0=None):
        """This row's instance shard in, its result shard out (every rank of
        a ``dp`` row passes the same shard and gets the same result)."""
        return self.solve_row(z0, zl, zu, cl, cu, lam0)


def make_hybrid_batch_solver(
    problem: Problem,
    options: SolveOptions = SolveOptions(),
    mesh=None,
    *,
    device=None,
    dtype=torch.float64,
) -> HybridBatchSolver:
    """Build the 2-D instance×segment sharded batch solver.

    Requires the structured block-KKT path (``block_kkt='on'``/``'auto'``
    with more than one segment) — the segment axis is the thing being
    sharded. ``device=None`` means ``"cuda"``, and raises without one.
    """
    from ..core.ipm import build_solver
    from ..core.scaling import scale_nlp
    from ..core.solve import _bind_fixed_mesh, _kkt_structured
    from ..core.transcribe import transcribe

    device = resolve_device(device)
    options = options or SolveOptions()
    if options.block_kkt == "auto":
        options = dataclasses.replace(options, block_kkt="on")
    mesh = mesh if mesh is not None else hybrid_mesh(device=device)
    names = tuple(mesh.mesh_dim_names or ())
    if set(names) != {"dp", "seg"}:
        raise ValueError(
            f"hybrid solver needs a ('dp','seg') mesh, got {names}"
        )
    nlp = transcribe(problem, device=device, dtype=dtype)
    scaled = scale_nlp(
        nlp.objective, nlp.constraints, nlp.zl, nlp.zu, nlp.cl, nlp.cu, nlp.z0,
        enabled=options.auto_scale, variable_scaling=options.variable_scaling,
        samples=options.scale_samples, device=device, dtype=dtype,
    )
    sk = _kkt_structured(problem, nlp, options)
    if sk is None:
        raise ValueError(
            "hybrid instance×segment sharding requires the structured "
            "block-KKT path (options.block_kkt='on'/'auto' with >1 segment)"
        )
    solver = build_solver(
        scaled.objective, scaled.constraints, nlp.n, nlp.m,
        options.ipm_options(),
        structured_kkt=_bind_fixed_mesh(sk, nlp, scaled, device, dtype),
    )
    dp_group = mesh.get_group("dp")
    n_dp = mesh.size(names.index("dp"))
    row = mesh.get_local_rank("dp")

    def to_dev(a):
        if a is None:
            return None
        return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                               device=device, dtype=dtype)

    def solve_row(z0, zl, zu, cl, cu, lam0=None):
        with segment_sharding(mesh, "seg"):
            return solver(*(to_dev(a) for a in (z0, zl, zu, cl, cu)), lam0=to_dev(lam0))

    def run(z0, zl, zu, cl, cu, lam0=None):
        batch = z0.shape[0]
        if batch % n_dp:
            raise ValueError(f"the batch of {batch} instances does not divide the "
                             f"{n_dp} rows of the dp axis")
        rows = slice(row * batch // n_dp, (row + 1) * batch // n_dp)
        res = solve_row(*(a[rows] for a in (z0, zl, zu, cl, cu)),
                        None if lam0 is None else lam0[rows])
        return type(res)(*(_gather_rows(f, dp_group, n_dp) for f in res))

    return HybridBatchSolver(
        problem=problem, nlp=nlp, scaled=scaled, run=run, mesh=mesh,
        n=nlp.n, m=nlp.m, solve_row=solve_row,
    )
