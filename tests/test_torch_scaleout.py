"""The port's scale-out solvers on torch.distributed, on the CPU (gloo).

``parallel/segment.py`` (one instance's block-KKT segment axis over ranks),
``parallel/hybrid.py`` (instances over ``dp``, segments over ``seg``),
``parallel/distributed.py`` and ``make_batch_solver(mesh=, donate=)``:

* multi-rank runs are separate processes (``torch_scaleout_worker.py``),
  one per rank, meeting on a ``FileStore`` under the test's own temporary
  directory (no port, so nothing collides under xdist), each with a
  timeout; a rank that dies fails the test;
* they are held to the JAX package's unsharded results on the same inputs,
  pinned by ``scripts/jax_scaleout_pins.py`` in
  ``scripts/jax_scaleout_pins.json`` (objective rtol 1e-9, z atol 1e-8, as
  ``tests/test_segment_shard.py`` and ``tests/test_hybrid.py`` hold the JAX
  package's own sharded solves; the iteration counts too, which the JAX
  package's own count keeps under a 1e-15 scaling of the start,
  ``hybrid_b4_jitter``), and to the port's unsharded solve;
* at world size 1 (a one-process gloo group in the test's own process) the
  sharded paths are bitwise equal to the unsharded ones.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.models import brachistochrone, hypersensitive
from lpopc_tpu_torch.parallel import distributed as dist
from lpopc_tpu_torch.parallel import segment
from lpopc_tpu_torch.parallel.batch import default_mesh, instance_grid_mesh, make_batch_solver
from lpopc_tpu_torch.parallel.hybrid import hybrid_mesh, make_hybrid_batch_solver
from lpopc_tpu_torch.parallel.segment import (make_segment_solver, seg_constrain, seg_gather,
                                              seg_lead, seg_replicated, seg_share,
                                              segment_mesh)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_scaleout_worker.py")
with open(os.path.join(ROOT, "scripts", "jax_scaleout_pins.json"), encoding="utf-8") as _f:
    PINS = json.load(_f)
JOB_TIMEOUT_S = 180
OBJ_RTOL, Z_ATOL = 1e-9, 1e-8
JOBS = {"pair": 2, "uneven": 3, "hybrid": 4}
CPU = dict(device="cpu")

sys.path.insert(0, HERE)
import torch_scaleout_worker as worker  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank job of the worker, all started at once: job -> list
    of each rank's results."""
    base = tmp_path_factory.mktemp("scaleout")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = {}
    for job, world in JOBS.items():
        for r in range(world):
            procs[job, r] = subprocess.Popen(
                [sys.executable, WORKER, job, str(r), str(world), str(base / f"{job}.store"),
                 str(base / f"{job}_{r}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    logs = {}
    try:
        for key, p in procs.items():
            logs[key], _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for (job, r), p in procs.items():
        assert p.returncode == 0, f"{job} rank {r} failed:\n{logs[job, r]}"
    return {job: [dict(np.load(base / f"{job}_{r}.npz")) for r in range(world)]
            for job, world in JOBS.items()}


@pytest.fixture(scope="module")
def world_one():
    """A one-process gloo group in this process, for the module's tests."""
    dist.initialize(**CPU)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _pinned(case):
    p = PINS[case]
    return {k: np.asarray(p[k]) for k in ("status", "iterations", "objective", "z")}


def _close_to(got, want, prefix):
    assert np.all(got[f"{prefix}_status"] == want["status"])
    assert np.array_equal(got[f"{prefix}_iterations"], want["iterations"])
    np.testing.assert_allclose(got[f"{prefix}_objective"], want["objective"], rtol=OBJ_RTOL)
    np.testing.assert_allclose(got[f"{prefix}_z"], want["z"], rtol=0, atol=Z_ATOL)


def _same_on_every_rank(results, prefix):
    for other in results[1:]:
        for k in ("status", "iterations", "objective", "z"):
            assert np.array_equal(other[f"{prefix}_{k}"], results[0][f"{prefix}_{k}"])


# ---------------------------------------------------------------- the hooks


def test_seg_constrain_noop_outside_policy():
    x = torch.ones(4, 3)
    a = np.ones((4, 3))
    assert seg_constrain(x) is x and seg_constrain(a) is a
    assert seg_replicated(x) is x and seg_lead(x) is x and seg_gather(x, 4, dim=0) is x
    assert seg_share(16) == (0, 16, 16)


@pytest.mark.parametrize("S,size,want", [
    (16, 2, [(0, 8, 8), (8, 16, 8)]),
    (16, 3, [(0, 6, 6), (6, 12, 6), (12, 16, 6)]),
    (2, 3, [(0, 1, 1), (1, 2, 1), (2, 2, 1)]),
])
def test_seg_share_split_and_padding(monkeypatch, S, size, want):
    """Rank r keeps segments [r·k, min((r+1)·k, S)), k = ⌈S/size⌉; a short
    share is padded with zeros (index 0, mask False: identity blocks)."""
    idx = np.arange(1, S + 1)
    for r in range(size):
        monkeypatch.setattr(segment, "_ACTIVE", segment._Policy(None, r, size))
        lo, hi, k = want[r]
        assert seg_share(S) == (lo, hi, k)
        got = seg_constrain(idx)
        assert got.shape == (k,) and np.array_equal(got[: hi - lo], idx[lo:hi])
        assert not got[hi - lo:].any()
        mask = seg_constrain(torch.ones(2, S, dtype=torch.bool), dim=1)
        assert mask.shape == (2, k) and int(mask.sum()) == 2 * (hi - lo)


@pytest.mark.parametrize("model", ["launch", "boostbrake"])
def test_assembly_split_over_ranks(monkeypatch, model):
    """The direct block assembly under a policy of ``size`` ranks: the ranks'
    interior and coupling blocks, in rank order, are the whole assembly's
    bitwise; their border partials sum to its border block; short shares
    are padded with identity blocks and zero coupling. The 4-phase launch
    (9 segments, linkages) and the 2-phase boost-brake (2 segments) give
    ranks with no segment of a phase, or none at all."""
    import importlib

    from lpopc_tpu_torch.core.scaling import scale_nlp
    from lpopc_tpu_torch.core.solve import _bind_fixed_mesh, _kkt_structured
    from lpopc_tpu_torch.core.transcribe import transcribe

    mod = importlib.import_module(f"lpopc_tpu_torch.models.{model}")
    problem = mod.make_problem(**({"degrees": (8,)} if model == "boostbrake" else {}))
    nlp = transcribe(problem, **CPU)
    sc = scale_nlp(nlp.objective, nlp.constraints, nlp.zl, nlp.zu, nlp.cl, nlp.cu, nlp.z0,
                   **CPU)
    bound = _bind_fixed_mesh(_kkt_structured(problem, nlp, SolveOptions(block_kkt="on")),
                             nlp, sc, "cpu", torch.float64)
    rng = np.random.default_rng(0)
    z = torch.as_tensor(np.stack([sc.z0] * 2))
    jb, hb = bound.jac_blocks(z), bound.hess_blocks(
        z, torch.as_tensor(rng.standard_normal((2, nlp.m))))
    d = torch.as_tensor(rng.uniform(0.5, 2.0, (2, nlp.m)))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, (2, nlp.n)))
    A, B, C = bound.assemble(jb, hb, d, w)
    S, b = A.shape[1], A.shape[-1]
    for size in (2, 3, 4, S + 1):
        parts = []
        for r in range(size):
            monkeypatch.setattr(segment, "_ACTIVE", segment._Policy(None, r, size))
            parts.append(seg_share(S) + bound.assemble(jb, hb, d, w))
        assert torch.equal(torch.cat([Ar[:, :hi - lo] for lo, hi, _, Ar, _, _ in parts], 1), A)
        assert torch.equal(torch.cat([Br[:, :hi - lo] for lo, hi, _, _, Br, _ in parts], 1), B)
        torch.testing.assert_close(sum(p[5] for p in parts), C, rtol=0, atol=1e-12)
        for lo, hi, k, Ar, Br, _ in parts:
            assert Ar.shape[1] == Br.shape[1] == k
            assert torch.equal(Ar[:, hi - lo:], torch.eye(b, dtype=A.dtype).expand(
                2, k - (hi - lo), b, b))
            assert not Br[:, hi - lo:].any()


def test_initialize_reads_the_environment(monkeypatch):
    """With no arguments, initialize() takes torchrun's MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK (gloo for device="cpu"); a second call
    is a no-op."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                     RANK="0").items():
        monkeypatch.setenv(k, v)
    assert not tdist.is_initialized()
    dist.initialize(**CPU)
    try:
        assert tdist.get_world_size() == 1 and tdist.get_backend() == "gloo"
        dist.initialize(**CPU)
        assert dist.global_instance_mesh(**CPU).mesh.tolist() == [0]
    finally:
        tdist.destroy_process_group()


# ------------------------------------------------- segment sharding, 2 and 3 ranks


@pytest.fixture(scope="module")
def port_unsharded():
    """The port's unsharded block solve of the segment problem (B = 1)."""
    bs = make_batch_solver(worker.seg_problem(), worker.seg_options(), **CPU)
    res = bs.run(*bs.nominal_inputs(1))
    return {f"seg_{k}": getattr(res, k)[0].numpy()
            for k in ("status", "iterations", "objective", "z")}


@pytest.mark.parametrize("job", ["pair", "uneven"])
def test_segment_sharded_matches_jax(ranks, job):
    want = {k: v[0] for k, v in _pinned("segment_b1").items()}
    for got in ranks[job]:
        _close_to(got, want, "seg")
    _same_on_every_rank(ranks[job], "seg")


@pytest.mark.parametrize("job", ["pair", "uneven"])
def test_segment_sharded_matches_port_unsharded(ranks, port_unsharded, job):
    want = {k.removeprefix("seg_"): v for k, v in port_unsharded.items()}
    _close_to(ranks[job][0], want, "seg")


@pytest.mark.parametrize("job,slots", [("pair", 8), ("uneven", 6)])
def test_segment_sharded_partitions(ranks, job, slots):
    """Each rank factors only its share of the 16 segments (8 of 2 ranks; 6
    of 3, the last share 4 real + 2 identity), with one all_reduce per
    factorization and one all_reduce + one all_gather per KKT solve."""
    for got in ranks[job]:
        assert got["seg_slots"].tolist() == [slots]
        n_fact = int(got["seg_factorizations"])
        n_solve = int(got["seg_all_gather"])
        assert n_fact > 0 and n_solve > 0
        assert int(got["seg_all_reduce"]) == n_fact + n_solve


# ------------------------------------------------------------ hybrid, 2 x 2


def test_hybrid_four_ranks_matches_jax(ranks):
    want = _pinned("hybrid_b4")
    assert PINS["hybrid_b4_jitter"]["spread"] == [[8, 8]] * 4   # JAX's counts do not move
    for got in ranks["hybrid"]:
        _close_to(got, want, "hyb")
    _same_on_every_rank(ranks["hybrid"], "hyb")


def test_hybrid_run_local_is_the_row_shard(ranks):
    rows = [int(got["hyb_row"]) for got in ranks["hybrid"]]
    assert rows == [0, 0, 1, 1]      # rows of consecutive ranks
    for got, row in zip(ranks["hybrid"], rows):
        for k in ("status", "iterations", "objective", "z"):
            assert np.array_equal(got[f"hyb_local_{k}"], got[f"hyb_{k}"][2 * row:2 * row + 2])


# ------------------------------------------- instances over ranks, 2 processes


def test_distributed_two_process_matches_jax(ranks):
    want = _pinned("distributed_b16")
    for r, got in enumerate(ranks["pair"]):
        _close_to(got, {k: v[8 * r:8 * r + 8] for k, v in want.items()}, "dist")
    # the global objective sum agrees across the processes
    total = sum(float(np.sum(got["dist_objective"])) for got in ranks["pair"])
    assert abs(total - float(np.sum(want["objective"]))) < 1e-9


@pytest.mark.parametrize("mesh", ["mesh", "grid"])
def test_batch_mesh_two_ranks_matches_jax(ranks, mesh):
    """make_batch_solver(mesh=default_mesh()) and mesh=instance_grid_mesh(1, 2):
    every rank gets the whole result of the global batch."""
    for got in ranks["pair"]:
        _close_to(got, _pinned("distributed_b16"), mesh)
    _same_on_every_rank(ranks["pair"], mesh)
    # the local shards the distributed solver returned are rows of it
    for r, got in enumerate(ranks["pair"]):
        assert np.array_equal(got["dist_iterations"], got[f"{mesh}_iterations"][8 * r:8 * r + 8])


# ------------------------------------------------------- world size 1, bitwise


def _bitwise(a, b):
    for k in ("status", "iterations", "objective", "z", "lam"):
        x, y = getattr(a, k), getattr(b, k)
        assert torch.equal(x, y), k


def test_segment_world_one_is_bitwise_unsharded(world_one):
    run = make_segment_solver(worker.seg_problem(), worker.seg_options(),
                              mesh=segment_mesh(**CPU), **CPU)
    res = run()
    plain = run.solver(*run.args)            # the same solver, no policy
    _bitwise(res, type(plain)(*(None if f is None else f[0] for f in plain)))
    assert int(res.status) == SOLVED


@pytest.fixture(scope="module")
def sweep():
    """A small brachistochrone sweep: its plain solver and inputs (B = 4)."""
    problem = brachistochrone.make_problem(degrees=(4, 4))
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=True))
    bs = make_batch_solver(problem, options, **CPU)
    z0, zl, zu, cl, cu = bs.nominal_inputs(4)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    pert = 0.1 * np.random.default_rng(0).uniform(-1, 1, (4, 2))
    zl[:, first:first + 2] += pert
    zu[:, first:first + 2] += pert
    args = tuple(torch.as_tensor(a) for a in (z0, zl, zu, cl, cu))
    return problem, options, args, bs.run(*args)


def test_batch_mesh_world_one_is_bitwise(world_one, sweep):
    problem, options, args, plain = sweep
    for mesh in (default_mesh(**CPU), instance_grid_mesh(1, 1, **CPU)):
        _bitwise(make_batch_solver(problem, options, mesh=mesh, **CPU).run(*args), plain)


def test_distributed_world_one_is_bitwise(world_one, sweep):
    problem, options, args, plain = sweep
    ds = dist.make_distributed_batch_solver(problem, options, **CPU)
    assert ds.local_batch_size(4) == 4
    _bitwise(ds.run_local(*args), plain)
    _bitwise(ds.inner.run(*args), plain)


def test_hybrid_world_one_matches_unsharded(world_one, port_unsharded):
    assert hybrid_mesh(**CPU).mesh.tolist() == [[0]]      # defaults: one row of one rank
    hb = make_hybrid_batch_solver(worker.seg_problem(), worker.seg_options(),
                                  mesh=hybrid_mesh(1, 1, **CPU), **CPU)
    assert hb.local_batch_size(2) == 2
    res = hb.run(*hb.nominal_inputs(2))
    for i in range(2):
        assert int(res.status[i]) == SOLVED
        np.testing.assert_allclose(res.z[i].numpy(), port_unsharded["seg_z"], rtol=0,
                                   atol=Z_ATOL)


@pytest.mark.parametrize("with_mesh", [False, True])
def test_donate_writes_the_result_into_z0(world_one, sweep, with_mesh):
    """donate=True: the same values as without, and res.z is z0's storage."""
    problem, options, args, plain = sweep
    mesh = default_mesh(**CPU) if with_mesh else None
    bs = make_batch_solver(problem, options, mesh=mesh, donate=True, **CPU)
    z0 = args[0].clone()
    ptr = z0.data_ptr()
    res = bs.run(z0, *args[1:])
    assert res.z is z0 and res.z.data_ptr() == ptr
    _bitwise(res, plain)
    with pytest.raises(ValueError, match="donate"):
        bs.run(args[0].numpy(), *args[1:])


def test_value_errors(world_one, sweep):
    problem, options, args, plain = sweep
    bs = make_batch_solver(problem, options, mesh=default_mesh(**CPU), **CPU)
    with pytest.raises(ValueError, match="warm bound duals"):
        bs.run(*args, zl_d=plain.zl_dual, zu_d=plain.zu_dual)
    seg_problem, off = worker.seg_problem(), SolveOptions(
        ipm=IPMOptions(tol=1e-8), mesh_method="none", block_kkt="off")
    with pytest.raises(ValueError, match="dp"):
        make_hybrid_batch_solver(seg_problem, worker.seg_options(),
                                 mesh=default_mesh(**CPU), **CPU)
    with pytest.raises(ValueError, match="block-KKT"):
        make_hybrid_batch_solver(seg_problem, off, mesh=hybrid_mesh(1, 1, **CPU), **CPU)
    with pytest.raises(ValueError, match="block-KKT"):
        make_segment_solver(seg_problem, off, mesh=segment_mesh(**CPU), **CPU)


def test_no_gpu_means_every_entry_raises():
    """Without a GPU nothing falls back to the CPU: device=None raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is honoured")
    problem = brachistochrone.make_problem(degrees=(3, 3))
    for call in (dist.initialize, dist.global_instance_mesh, default_mesh, segment_mesh,
                 hybrid_mesh, lambda: instance_grid_mesh(1, 1),
                 lambda: make_batch_solver(problem, mesh=object()),
                 lambda: dist.make_distributed_batch_solver(problem),
                 lambda: make_segment_solver(hypersensitive.make_problem(tf=40.0)),
                 lambda: make_hybrid_batch_solver(hypersensitive.make_problem(tf=40.0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
