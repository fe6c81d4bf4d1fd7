#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It

1. ``device``       names the card (torch and ``nvidia-smi``);
2. ``build``        compiles ``lpopc_tpu_torch/csrc/*.cu`` with ``nvcc``;
3. ``kernels``      holds both hand-written kernels (batched Cholesky K1,
                    batched Cholesky-solve K2) against their plain PyTorch
                    versions on the card, and times kernel, plain version
                    and the one-call library equivalent with CUDA events;
4. ``sweep_lane``   solves the 512-instance brachistochrone sweep through the
                    kernels (``lane_kkt=True``) and checks the objectives;
5. ``sweep_apply``  the same sweep on the library-matmul route
                    (``lane_kkt=False``), for comparison;

and prints one JSON line per phase, then a ``{"kernels": [...]}`` summary, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device": ...}``.
Any failure raises: the exit code is then nonzero and no result line is
printed. Without a CUDA device it exits at once with an error.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device available (torch.cuda.is_available() is False)")

from lpopc_tpu_torch.core.ipm import SOLVED, IPMOptions
from lpopc_tpu_torch.core.solve import SolveOptions
from lpopc_tpu_torch.models import brachistochrone
from lpopc_tpu_torch.ops import batched_linalg as bl
from lpopc_tpu_torch.parallel.batch import make_batch_solver
from lpopc_tpu_torch.utils import build

DEVICE = torch.device("cuda", 0)

# The sweep of the JAX package's bench.py: degrees (6, 6) (n = 53, m = 37),
# 512 instances, terminal target perturbed by 0.2 * U(-1, 1) * var_scale, seed 0.
DEGREES = (6, 6)
BATCH = 512
SEED = 0
# Objectives of the first 8 instances of that sweep, computed with the JAX
# package (lpopc_tpu, CPU, x64, lane_kkt=True in interpret mode; 13 iterations
# each). obj_scale is 1.0 for this model, so these are final times.
REFERENCE_OBJECTIVES = (
    0.8199081764046097, 0.7775134388029006, 0.8438688680288589, 0.8279257292394469,
    0.8293333348876281, 0.826610449430012, 0.8297690805844111, 0.8239430186642959,
)
OBJECTIVE_TOL = 1e-7
ANALYTIC_TOL = 1e-7     # unperturbed target against the cycloid's final time

# Peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM; outside the
# tensor cores, where both kernels run, 67 TFLOP/s in float32 and half of
# that in float64 (the sheet rounds it to 34).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 33.5e12, torch.float32: 67e12}

KERNEL_SHAPES = ((512, 53, torch.float64), (130, 16, torch.float64), (64, 24, torch.float32))
REL_TOL = {torch.float64: 1e-10, torch.float32: 5e-3}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def event_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median device time of ``fn()`` in milliseconds, one CUDA-event pair
    per call after warm-up. The inputs (a few MB) stay in the L2 cache
    between calls, as they are for the solver, which factors a matrix it
    has just assembled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def spd_batch(B: int, n: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    K = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    b = rng.standard_normal((B, n))
    return (torch.as_tensor(K, device=DEVICE, dtype=dtype),
            torch.as_tensor(b, device=DEVICE, dtype=dtype))


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def bound(bytes_moved: float, flops: float, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def phase_kernels():
    """K1 and K2 against their plain versions on the card; returns the
    measurements at the sweep's shape (512, 53) f64."""
    checks = []
    main = {}
    for B, n, dtype in KERNEL_SHAPES:
        K, b = spd_batch(B, n, dtype, seed=B * 1000 + n)
        L = bl.lane_cholesky(K)
        L_plain = bl.lane_cholesky_plain(K)
        x = bl.lane_cho_solve(L_plain, b)
        x_plain = bl.lane_cho_solve_plain(L_plain, b)
        torch.cuda.synchronize()
        tol = REL_TOL[dtype]
        e1, e2 = rel_err(L, L_plain), rel_err(x, x_plain)
        if not (e1 <= tol and e2 <= tol):
            raise AssertionError(
                f"kernel disagrees with its plain version at {(B, n, dtype)}: "
                f"cholesky rel err {e1}, cho_solve rel err {e2}, tolerance {tol}")
        if float(torch.triu(L, diagonal=1).abs().max()) != 0.0:
            raise AssertionError("lane_cholesky left the upper triangle nonzero")
        # a broadcast (stride-0) factor gives what the materialized batch gives
        xb = bl.lane_cho_solve(L_plain[0], b)
        xb_ref = bl.lane_cho_solve_plain(L_plain[:1].expand(B, -1, -1).contiguous(), b)
        e3 = rel_err(xb, xb_ref)
        if not e3 <= tol:
            raise AssertionError(f"broadcast-L solve disagrees: rel err {e3}")
        checks.append({"B": B, "n": n, "dtype": str(dtype).replace("torch.", ""),
                       "cholesky_rel_err": e1, "cho_solve_rel_err": e2,
                       "broadcast_rel_err": e3, "rel_tol": tol})
        if (B, n, dtype) == KERNEL_SHAPES[0]:
            esz = K.element_size()
            # Bytes each function must move: K is symmetric and L lower
            # triangular, so B*n*(n+1)/2 entries of either are read; K1
            # writes the full (B, n, n) factor (zeros above the diagonal),
            # K2 reads b and writes x.
            tri = B * n * (n + 1) // 2
            k1_bound, k1_by = bound((tri + B * n * n) * esz, B * n ** 3 / 3.0, dtype)
            k2_bound, k2_by = bound((tri + 2 * B * n) * esz, 2.0 * B * n * n, dtype)
            main["lane_cholesky"] = {
                "max_abs_err": float((L - L_plain).abs().max()),
                "ms": event_ms(lambda: bl.lane_cholesky(K)),
                "plain_ms": event_ms(lambda: bl.lane_cholesky_plain(K), warmup=2, reps=20),
                "library_ms": event_ms(lambda: torch.linalg.cholesky(K)),
                "bound_ms": k1_bound, "bound_by": k1_by,
            }
            bcol = b.unsqueeze(-1)
            main["lane_cho_solve"] = {
                "max_abs_err": float((x - x_plain).abs().max()),
                "ms": event_ms(lambda: bl.lane_cho_solve(L_plain, b)),
                "plain_ms": event_ms(lambda: bl.lane_cho_solve_plain(L_plain, b),
                                     warmup=2, reps=20),
                "library_ms": event_ms(lambda: torch.cholesky_solve(bcol, L_plain)),
                "bound_ms": k2_bound, "bound_by": k2_by,
            }
    # a non-PD input: NaN diagonal from the bad pivot on, no exception; the
    # other matrices of the batch are untouched
    K, _ = spd_batch(8, 53, torch.float64, seed=7)
    K[3] = -K[3]
    L = bl.lane_cholesky(K)
    torch.cuda.synchronize()
    d = torch.diagonal(L, dim1=1, dim2=2)
    if not bool(torch.isnan(d[3]).all()):
        raise AssertionError("lane_cholesky: non-PD input did not give a NaN diagonal")
    if not bool(torch.isfinite(d[[0, 1, 2, 4, 5, 6, 7]]).all()):
        raise AssertionError("lane_cholesky: NaN leaked into other matrices of the batch")
    emit("kernels", kernels=["lane_cholesky", "lane_cho_solve"], checks=checks,
         non_pd_nan_diagonal=True, at_512x53_f64=main)
    return main


def sweep_inputs(bs, batch: int):
    rng = np.random.default_rng(SEED)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    # perturb the terminal target (xf, yf) per instance: the pinned xf rows
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    xf_rows = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs.scaled.var_scale[xf_rows][None, :]
    zl[:, xf_rows] += pert
    zu[:, xf_rows] += pert
    return tuple(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                 for a in (z0, zl, zu, cl, cu))


def reset_counters(bs):
    bl.lane_cholesky.launches = 0
    bl.lane_cho_solve.launches = 0
    bs.solver.host_syncs = 0
    bs.solver.outer_iterations = 0


def phase_sweep(name: str, lane_kkt: bool):
    problem = brachistochrone.make_problem(degrees=DEGREES)
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=lane_kkt))
    bs = make_batch_solver(problem, options)          # device=None: the GPU
    args = sweep_inputs(bs, BATCH)

    def run_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bs.run(*args)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    _, warm_s = run_once()                            # warm-up (first-use costs)
    walls = []
    for rep in range(3):
        if rep == 2:
            # the counted run: every count is zeroed just before it
            reset_counters(bs)
        res, wall = run_once()
        walls.append(wall)
    launches = {"lane_cholesky": bl.lane_cholesky.launches,
                "lane_cho_solve": bl.lane_cho_solve.launches}
    host_syncs, outer = bs.solver.host_syncs, bs.solver.outer_iterations

    status = res.status.cpu().numpy()
    objective = res.objective.cpu().numpy()
    iterations = res.iterations.cpu().numpy()
    solved_frac = float(np.mean(status == SOLVED))
    if res.z.shape != (BATCH, bs.n) or not np.all(np.isfinite(objective)):
        raise AssertionError(f"{name}: result has a wrong shape or non-finite objectives")
    if solved_frac != 1.0:
        raise AssertionError(f"{name}: solved_frac {solved_frac} != 1.0")
    obj_err = float(np.max(np.abs(objective[:8] - np.asarray(REFERENCE_OBJECTIVES))))
    if not obj_err <= OBJECTIVE_TOL:
        raise AssertionError(
            f"{name}: first 8 objectives differ from the reference by {obj_err}")
    if lane_kkt and not (launches["lane_cholesky"] > 0 and launches["lane_cho_solve"] > 0):
        raise AssertionError(f"{name}: the sweep did not launch both kernels: {launches}")
    if not lane_kkt and (launches["lane_cholesky"] or launches["lane_cho_solve"]):
        raise AssertionError(f"{name}: the library-matmul route launched a kernel: {launches}")

    # the unperturbed target as a batch of one, against the cycloid
    res1 = bs.run(*(torch.as_tensor(a, device=DEVICE, dtype=torch.float64)
                    for a in bs.nominal_inputs(1)))
    tf = float(res1.objective[0]) / bs.scaled.obj_scale
    tf_err = abs(tf - brachistochrone.analytic_tf())
    if int(res1.status[0]) != SOLVED or not tf_err <= ANALYTIC_TOL:
        raise AssertionError(
            f"{name}: nominal solve status {int(res1.status[0])}, tf {tf}, "
            f"differs from the analytic optimum by {tf_err}")

    wall = statistics.median(walls)
    emit(name, lane_kkt=lane_kkt, batch=BATCH, n=bs.n, m=bs.m,
         solved_frac=solved_frac, wall_s=wall, wall_s_runs=walls, warmup_s=warm_s,
         solves_per_s=BATCH * solved_frac / wall,
         iters_p50=int(np.median(iterations)), iters_max=int(iterations.max()),
         outer_iterations=outer, launches=launches,
         launches_per_solve={k: v / BATCH for k, v in launches.items()},
         host_syncs=host_syncs, host_syncs_per_iteration=host_syncs / max(outer, 1),
         first8_objective_max_err=obj_err, nominal_tf=tf, nominal_tf_err=tf_err,
         nominal_iterations=int(res1.iterations[0]))
    return launches


def main():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    log = build.build("batched_linalg", extra_flags=("-Xptxas", "-v"))
    bl._library()                                      # load and bind
    emit("build", seconds=time.perf_counter() - t0, library=build.library_path("batched_linalg"),
         ptxas=[ln for ln in log.splitlines() if "registers" in ln or "spill" in ln][:16])

    measured = phase_kernels()
    launches = phase_sweep("sweep_lane", lane_kkt=True)
    phase_sweep("sweep_apply", lane_kkt=False)

    source = "lpopc_tpu_torch/csrc/batched_linalg.cu"
    replaces = {"lane_cholesky": "lpopc_tpu/ops/batched_linalg.py:128",
                "lane_cho_solve": "lpopc_tpu/ops/batched_linalg.py:193"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source, "replaces": replaces[k],
         "launches": launches[k], **measured[k]}
        for k in ("lane_cholesky", "lane_cho_solve")
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
