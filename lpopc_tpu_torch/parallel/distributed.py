"""Multi-process instance-axis distribution on ``torch.distributed``.

The reference is strictly single-process. The scale-out here runs one
process per GPU — one rank drives one GPU, and a mesh of n ranks is n
processes — across one host or many, with the instance grid split over
every rank. The batched IPM is pure data parallelism over instances, so the
solve itself runs no collective at all: each process feeds its local shard
of the instance grid and reads back its local shard of the results, and
cross-process traffic starts only when the caller reduces results.

Counterpart of the JAX package's ``parallel/distributed.py`` (there
``jax.distributed`` joins processes whose devices form one global mesh).

Usage (same program on every process):

    from lpopc_tpu_torch.parallel import distributed as dist
    dist.initialize()                     # env-driven (or pass explicitly)
    mesh = dist.global_instance_mesh()
    bs = dist.make_distributed_batch_solver(problem, options, mesh)
    res = bs.run_local(z0_local, ...)     # per-process local shards in/out

The backend is NCCL on CUDA devices and gloo on the CPU; a 2-process gloo
run on the CPU is the test of the multi-process path
(``tests/test_torch_scaleout.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as tdist

from ..core.problem import Problem
from ..core.solve import SolveOptions
from ..utils.device import device_mesh, resolve_device
from .batch import BatchSolver, make_batch_solver


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> None:
    """Bring up the default process group (idempotent).

    Arguments default to the standard environment of ``torchrun``
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as
    ``jax.distributed.initialize`` reads its own, so launchers can stay
    generic. ``coordinator_address`` is ``host:port`` (a TCP rendezvous on
    that address) or an ``init_method`` URL such as ``tcp://…`` or
    ``file://…``. With nothing given and nothing in the environment the
    group is one process on an in-memory store, so the same program runs
    unmodified on one GPU.

    ``device`` (``None`` means ``"cuda"``, and raises without one) picks the
    backend: NCCL for CUDA, with this process bound to GPU
    ``process_id % device_count``, and gloo for ``"cpu"``.
    """
    device = resolve_device(device)
    if tdist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    else:
        backend = "gloo"
    kw = dict(backend=backend, world_size=num_processes, rank=process_id)
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a coordinator_address "
                             "(or MASTER_ADDR/MASTER_PORT in the environment)")
        kw["store"] = tdist.HashStore()
    elif "://" in coordinator_address:
        kw["init_method"] = coordinator_address
    else:
        kw["init_method"] = f"tcp://{coordinator_address}"
    tdist.init_process_group(**kw)


def global_instance_mesh(axis_name: str = "dp", *, device=None):
    """1-D ``DeviceMesh`` over every rank of the default process group
    (every process sees the same rank list after :func:`initialize`)."""
    device = resolve_device(device)   # before any process-group call
    return device_mesh(device, list(range(tdist.get_world_size())), (axis_name,))


@dataclass
class DistributedBatchSolver:
    """Wraps a mesh-split :class:`BatchSolver` with per-process local-shard
    input/output."""

    inner: BatchSolver
    mesh: object

    @property
    def nlp(self):
        return self.inner.nlp

    @property
    def scaled(self):
        return self.inner.scaled

    def local_batch_size(self, global_batch: int) -> int:
        nproc = self.mesh.mesh.numel()
        assert global_batch % nproc == 0, (
            f"global batch {global_batch} must divide process count {nproc}"
        )
        return global_batch // nproc

    def nominal_local_inputs(self, global_batch: int):
        """Per-process local shards of the nominal inputs (every process
        holds its own batch slice; perturb these locally)."""
        return self.inner.nominal_inputs(self.local_batch_size(global_batch))

    def run_local(self, z0, zl, zu, cl, cu, lam0=None):
        """Solve this process's local instance shard; returns its local
        shard of the batched ``IPMResult``. No collective: the instances
        are independent, so the shard is solved where it lies."""
        return self.inner.run_local(z0, zl, zu, cl, cu, lam0=lam0)


def make_distributed_batch_solver(
    problem: Problem,
    options: SolveOptions = SolveOptions(),
    mesh=None,
    two_stage: bool = False,
    *,
    device=None,
    dtype=torch.float64,
) -> DistributedBatchSolver:
    """Mesh-split batch solver with local-shard IO (multi-process entry
    point). The instance axis is split over every rank of ``mesh`` (default
    :func:`global_instance_mesh`); ``inner.run`` takes global inputs and
    returns the whole result on every rank, :meth:`DistributedBatchSolver.
    run_local` the local shard. ``device=None`` means ``"cuda"``."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else global_instance_mesh(device=device)
    inner = make_batch_solver(problem, options, mesh=mesh, two_stage=two_stage,
                              device=device, dtype=dtype)
    return DistributedBatchSolver(inner=inner, mesh=mesh)
