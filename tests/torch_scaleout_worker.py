"""One rank of a multi-process run of the port's scale-out solvers on gloo.

Launched by tests/test_torch_scaleout.py, one process per rank:

    python torch_scaleout_worker.py JOB RANK WORLD STORE OUT

The ranks meet on a ``FileStore`` at STORE (a path under the test's own
temporary directory, so concurrent test runs cannot collide), run JOB and
write what they got to OUT (``.npz``). Jobs:

* ``pair`` (2 ranks): the segment-sharded solve of the hypersensitive
  problem (tf = 40, degrees (6,) * 16: S = 16, 8 per rank);
  ``make_distributed_batch_solver(...).run_local`` on the 16-instance
  brachistochrone sweep of tests/distributed_worker.py (8 local instances a
  rank); ``make_batch_solver(mesh=default_mesh())`` and
  ``mesh=instance_grid_mesh(1, 2)`` on the same 16 as global inputs;
* ``uneven`` (3 ranks): the segment-sharded solve with S = 16 over 3 ranks
  (6, 6 and 4 segments, the last share padded by 2 identity blocks);
* ``hybrid`` (4 ranks): ``make_hybrid_batch_solver`` on a 2 × 2
  ``("dp", "seg")`` mesh, 4 perturbed instances (tests/test_hybrid.py's),
  through ``run`` and through ``run_local``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpopc_tpu_torch.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu_torch.core.solve import SolveOptions  # noqa: E402
from lpopc_tpu_torch.models import brachistochrone, hypersensitive  # noqa: E402
from lpopc_tpu_torch.parallel import distributed as dist  # noqa: E402
from lpopc_tpu_torch.parallel.batch import default_mesh, instance_grid_mesh  # noqa: E402
from lpopc_tpu_torch.parallel.batch import make_batch_solver  # noqa: E402
from lpopc_tpu_torch.parallel.hybrid import hybrid_mesh, make_hybrid_batch_solver  # noqa: E402
from lpopc_tpu_torch.parallel.segment import make_segment_solver, segment_mesh  # noqa: E402

CPU = dict(device="cpu")
SEG_DEGREES, SEG_TF = (6,) * 16, 40.0
DIST_BATCH = 16


def seg_problem():
    return hypersensitive.make_problem(tf=SEG_TF, degrees=SEG_DEGREES)


def seg_options():
    return SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60), mesh_method="none",
                        block_kkt="on")


def brach_options():
    return SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60))


def fields(prefix, res):
    return {f"{prefix}_{k}": np.asarray(getattr(res, k))
            for k in ("status", "iterations", "objective", "z")}


def hybrid_inputs(bs, batch=4):
    """tests/test_hybrid.py's perturbation of the pinned initial state."""
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    sl = slice(pl.var_offset, pl.var_offset + 1)
    d = 0.05 * np.arange(batch)[:, None] * bs.scaled.var_scale[sl][None, :]
    zl[:, sl] += d
    zu[:, sl] += d
    z0[:, sl] += d
    return z0, zl, zu, cl, cu


def local_sweep(bs, rank):
    """tests/distributed_worker.py's local shard of process ``rank``."""
    z0, zl, zu, cl, cu = bs.nominal_local_inputs(DIST_BATCH)
    rng = np.random.default_rng(42 + rank)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    xf = slice(first, first + 2)
    pert = 0.1 * rng.uniform(-1, 1, (z0.shape[0], 2)) * bs.scaled.var_scale[xf][None, :]
    zl[:, xf] += pert
    zu[:, xf] += pert
    return z0, zl, zu, cl, cu


def counted_segment_solve():
    """The segment-sharded solve, with the collectives it ran and the number
    of segment slots each factorization held on this rank."""
    from lpopc_tpu_torch.core import kkt_blocks

    counts = {"all_reduce": 0, "all_gather": 0}
    slots = []
    real = {k: getattr(torch.distributed, k) for k in counts}
    real_factor = kkt_blocks.factor_from_blocks

    def counting(name):
        def call(*a, **kw):
            counts[name] += 1
            return real[name](*a, **kw)
        return call

    def factor(A, B, C):
        slots.append(A.shape[1])
        return real_factor(A, B, C)

    run = make_segment_solver(seg_problem(), seg_options(), mesh=segment_mesh(**CPU), **CPU)
    for k in counts:
        setattr(torch.distributed, k, counting(k))
    kkt_blocks.factor_from_blocks = factor
    try:
        res = run()
    finally:
        for k in counts:
            setattr(torch.distributed, k, real[k])
        kkt_blocks.factor_from_blocks = real_factor
    return {**fields("seg", res), "seg_all_reduce": np.asarray(counts["all_reduce"]),
            "seg_all_gather": np.asarray(counts["all_gather"]),
            "seg_factorizations": np.asarray(len(slots)),
            "seg_slots": np.asarray(sorted(set(slots)))}


def job_pair(rank, world):
    out = counted_segment_solve()
    ds = dist.make_distributed_batch_solver(
        brachistochrone.make_problem(degrees=(6, 6)), brach_options(), **CPU)
    local = local_sweep(ds, rank)
    out.update(fields("dist", ds.run_local(*local)))
    # the global batch: every rank's local shard, in rank order
    shards = [None] * world
    torch.distributed.all_gather_object(shards, [np.asarray(a) for a in local])
    glob = tuple(np.concatenate([s[i] for s in shards]) for i in range(5))
    for name, mesh in (("mesh", default_mesh(**CPU)), ("grid", instance_grid_mesh(1, 2, **CPU))):
        bs = make_batch_solver(brachistochrone.make_problem(degrees=(6, 6)), brach_options(),
                               mesh=mesh, **CPU)
        out.update(fields(name, bs.run(*glob)))
    return out


def job_uneven(rank, world):
    return counted_segment_solve()


def job_hybrid(rank, world):
    mesh = hybrid_mesh(n_dp=2, n_seg=2, **CPU)
    hb = make_hybrid_batch_solver(seg_problem(), seg_options(), mesh=mesh, **CPU)
    args = hybrid_inputs(hb)
    out = fields("hyb", hb.run(*args))
    row = mesh.get_local_rank("dp")
    per = hb.local_batch_size(4)
    out.update(fields("hyb_local", hb.run_local(*(a[row * per:(row + 1) * per]
                                                  for a in args))))
    out["hyb_row"] = np.asarray(row)
    return out


JOBS = {"pair": job_pair, "uneven": job_uneven, "hybrid": job_hybrid}


def main():
    job, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.initialize(f"file://{store}", world, rank, **CPU)
    try:
        results = JOBS[job](rank, world)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(out, **results)
    print(f"RANK {rank} done", flush=True)


if __name__ == "__main__":
    main()
