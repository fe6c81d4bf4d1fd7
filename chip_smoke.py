#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and nothing from the network. It

1. ``device``       names the card (torch and ``nvidia-smi``);
2. ``build``        compiles ``lpopc_tpu_torch/csrc/*.cu`` with ``nvcc``;
3. ``kernels``      holds both hand-written kernels (batched Cholesky K1,
                    batched Cholesky-solve K2) against their plain PyTorch
                    versions on the card, in both variants (shared and
                    global memory), asserts which variant ran at each shape,
                    checks the NaN contracts, and times kernel, plain
                    version and the one-call library equivalent with CUDA
                    events, beside the launch floor of the card and K2's
                    time against the batch;
4. ``sweep_lane``   solves the 512-instance brachistochrone sweep through the
                    kernels (``lane_kkt=True``) and checks the objectives;
5. ``sweep_apply``  the same sweep on the library-matmul route
                    (``lane_kkt=False``), for comparison;
6. ``sweep_lane_large`` a 64-instance sweep at degrees (24, 24) (n = 197),
                    through both kernels' shared variants;

and prints one JSON line per phase, then a ``{"kernels": [...]}`` summary, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device": ...}``.
Any failure raises: the exit code is then nonzero and no result line is
printed. Without a CUDA device it exits at once with an error.
"""

from __future__ import annotations

import json
import re
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
# The same sweep at degrees (24, 24) (n = 197, m = 145), 64 instances: the
# first 4 objectives, from the JAX package (CPU, x64, lane_kkt=False; 15, 15,
# 13, 13 iterations). The first 4 perturbations are those of a batch of 4.
DEGREES_LARGE = (24, 24)
BATCH_LARGE = 64
REFERENCE_OBJECTIVES_LARGE = (
    0.8199081764044944, 0.7775134388029132, 0.8438688680217514, 0.8279257292302437,
)
# What the counted run of each lane sweep takes (the JAX package's iteration
# counts; one K1 launch per regularization round, five K2 launches per
# iteration; one host sync per loop condition).
EXPECT_LANE = {"iters_p50": 13, "first_iterations": [13] * 8,
               "launches": {"lane_cholesky": 13, "lane_cho_solve": 65}, "host_syncs": 40}
EXPECT_LANE_LARGE = {"iters_p50": 13, "first_iterations": [15, 15, 13, 13],
                     "launches": {"lane_cholesky": 48, "lane_cho_solve": 240}}
OBJECTIVE_TOL = 1e-7
ANALYTIC_TOL = 1e-7     # unperturbed target against the cycloid's final time

# Peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM; 67 TFLOP/s in
# float64 on the tensor cores (K1's trailing update runs there; outside them
# float64 has half that) and 67 TFLOP/s in float32 outside them (TF32 is
# not float32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}

# event_ms: cycles per ms of a GPU sleep (at least the H100's boost clock,
# so a sleep lasts at least as long as asked), and the longest sleep
SLEEP_CYCLES_PER_MS = 2.0e6
MAX_SLEEP_MS = 50.0

F64, F32 = torch.float64, torch.float32
# (B, n, dtype) -> the variants of (K1, K2) that must run there. K1 is
# shared up to n = 239 (f64) / 339 (f32), K2 up to 240 / 256; K1 works in
# panels of 32 columns, so the small-batch shapes put a panel edge at each
# side of n = 1, 32, 64 and of each split.
KERNEL_SHAPES = {
    (512, 53, F64): ("shared", "shared"),
    (130, 16, F64): ("shared", "shared"),
    (64, 24, F32): ("shared", "shared"),
    (64, 197, F64): ("shared", "shared"),
    (64, 197, F32): ("shared", "shared"),
    (8, 700, F64): ("global", "global"),
    (16, 360, F32): ("global", "global"),
    (512, 300, F64): ("global", "global"),    # K1's panel-step grid spans several waves
    (3, 1, F64): ("shared", "shared"),
    (3, 31, F64): ("shared", "shared"),
    (3, 32, F64): ("shared", "shared"),
    (3, 33, F64): ("shared", "shared"),
    (3, 64, F64): ("shared", "shared"),
    (3, 65, F64): ("shared", "shared"),
    (3, 239, F64): ("shared", "shared"),
    (3, 240, F64): ("global", "shared"),
    (3, 241, F64): ("global", "global"),
    (3, 256, F64): ("global", "global"),
    (3, 339, F32): ("shared", "global"),
    (3, 340, F32): ("global", "global"),
}
MAIN_SHAPE = (512, 53, F64)                   # the sweep's
TIMED_SHAPES = (MAIN_SHAPE, (64, 197, F64), (8, 700, F64))
REL_TOL = {F64: 1e-10, F32: 5e-3}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_summary(log: str):
    """One line per kernel of ``nvcc -Xptxas -v``'s output: its short name
    and template arguments, registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d((?:lane|cholesky)_\w+?)I([df])(?:Li(\d+)E)?", m.group(1))
            name = (f"{k.group(1)}<{'f64' if k.group(2) == 'd' else 'f32'}"
                    f"{',' + k.group(3) if k.group(3) else ''}>") if k else m.group(1)
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def event_ms(fn, warmup: int = 5, reps: int = 30, batches: int = 3) -> float:
    """Device time of one ``fn()`` in milliseconds: CUDA events around
    ``reps`` calls divided by ``reps``, the median of ``batches`` batches,
    after warm-up. A GPU sleep queued first keeps the device busy while the
    host enqueues the batch, so the calls run back to back and the host's
    own time per call (Python, ctypes, allocation) is not counted, unless
    the batch's host time passes MAX_SLEEP_MS, as for host-paced code such
    as the plain versions. The inputs (a few MB) stay in the L2 cache
    between calls, as they are for the solver, which factors a matrix it
    has just assembled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_cycles = int(min(2.0 * host_ms * reps, MAX_SLEEP_MS) * SLEEP_CYCLES_PER_MS)
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
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


def variant_launched(w) -> str:
    """The variant of wrapper ``w`` that launched since its counts were zeroed."""
    if w.launches != 1:
        raise AssertionError(f"expected one launch, counted {w.launches}")
    return "shared" if w.launches_shared == 1 else "global"


def kernel_times(K, b, L_plain, x, x_plain, L):
    """Kernel, plain and library times and the bound of K1 and K2 at one shape."""
    B, n, _ = K.shape
    dtype, esz = K.dtype, K.element_size()
    big = n > 100                        # the plain versions take n launches per column
    plain_reps = dict(warmup=1, reps=5) if big else dict(warmup=2, reps=20)
    # Bytes each function must move: K is symmetric and L lower triangular,
    # so B*n*(n+1)/2 entries of either are read; K1 writes the full (B, n, n)
    # factor (zeros above the diagonal), K2 reads b and writes x.
    tri = B * n * (n + 1) // 2
    k1_bound, k1_by = bound((tri + B * n * n) * esz, B * n ** 3 / 3.0, dtype)
    k2_bound, k2_by = bound((tri + 2 * B * n) * esz, 2.0 * B * n * n, dtype)
    bcol = b.unsqueeze(-1)
    return {
        "lane_cholesky": {
            "max_abs_err": float((L - L_plain).abs().max()),
            "ms": event_ms(lambda: bl.lane_cholesky(K)),
            "plain_ms": event_ms(lambda: bl.lane_cholesky_plain(K), **plain_reps),
            # cholesky_ex: torch.linalg.cholesky waits for the host to check
            # `info` after every call, which would time the round trip
            "library_ms": event_ms(lambda: torch.linalg.cholesky_ex(K, check_errors=False)),
            "bound_ms": k1_bound, "bound_by": k1_by,
        },
        "lane_cho_solve": {
            "max_abs_err": float((x - x_plain).abs().max()),
            "ms": event_ms(lambda: bl.lane_cho_solve(L_plain, b)),
            "plain_ms": event_ms(lambda: bl.lane_cho_solve_plain(L_plain, b), **plain_reps),
            "library_ms": event_ms(lambda: torch.cholesky_solve(bcol, L_plain)),
            "bound_ms": k2_bound, "bound_by": k2_by,
        },
    }


def check_nan_contracts():
    """K1: a non-PD matrix gives a NaN diagonal from its bad pivot on, with
    no exception, in both variants. K2: a zero diagonal in one system gives
    a non-finite x there, in both variants. The other systems of the batch
    stay finite."""
    for n in (53, 300):                  # K1 shared, K1 global
        K, _ = spd_batch(8, n, F64, seed=7)
        K[3] = -K[3]
        L = bl.lane_cholesky(K)
        torch.cuda.synchronize()
        d = torch.diagonal(L, dim1=1, dim2=2)
        if not bool(torch.isnan(d[3]).all()):
            raise AssertionError(f"lane_cholesky n={n}: non-PD input did not give a NaN diagonal")
        if not bool(torch.isfinite(d[[0, 1, 2, 4, 5, 6, 7]]).all()):
            raise AssertionError(f"lane_cholesky n={n}: NaN leaked into other matrices")
    for n in (53, 700):                  # K2 shared, K2 global
        K, b = spd_batch(8, n, F64, seed=8)
        L = bl.lane_cholesky_plain(K)
        L[5, n // 2, n // 2] = 0.0
        x = bl.lane_cho_solve(L, b)
        torch.cuda.synchronize()
        if bool(torch.isfinite(x[5]).all()):
            raise AssertionError(f"lane_cho_solve n={n}: a zero diagonal gave a finite x")
        if not bool(torch.isfinite(x[[0, 1, 2, 3, 4, 6, 7]]).all()):
            raise AssertionError(f"lane_cho_solve n={n}: non-finite x leaked into other systems")


def random_factor(B: int, n: int, seed: int):
    """A well-conditioned random lower-triangular batch and right-hand side,
    made on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    L = torch.tril(torch.rand((B, n, n), generator=g, device=DEVICE, dtype=F64) - 0.5,
                   diagonal=-1) / n
    L.diagonal(dim1=1, dim2=2).add_(2.0)
    return L, torch.rand((B, n), generator=g, device=DEVICE, dtype=F64)


def solve_batch_scan():
    """K2's time against the batch at n = 53 and 197 (f64): where one system
    takes as long as a full wave, the time is the latency of one warp's
    dependent steps, not bandwidth."""
    out = {}
    for n in (53, 197):
        for B in (1, 132, 512, 2048):
            L, b = random_factor(B, n, seed=10)
            out[f"n{n}_B{B}"] = event_ms(lambda: bl.lane_cho_solve(L, b))
    return out


def phase_kernels():
    """K1 and K2 against their plain versions on the card, at every shape of
    KERNEL_SHAPES; returns the measurements at TIMED_SHAPES."""
    checks = []
    timed = {}
    for (B, n, dtype), (want_k1, want_k2) in KERNEL_SHAPES.items():
        K, b = spd_batch(B, n, dtype, seed=B * 1000 + n)
        bl.reset_launches()
        L = bl.lane_cholesky(K)
        got_k1 = variant_launched(bl.lane_cholesky)
        L_plain = bl.lane_cholesky_plain(K)
        x = bl.lane_cho_solve(L_plain, b)
        got_k2 = variant_launched(bl.lane_cho_solve)
        x_plain = bl.lane_cho_solve_plain(L_plain, b)
        torch.cuda.synchronize()
        if (got_k1, got_k2) != (want_k1, want_k2):
            raise AssertionError(f"at {(B, n, dtype)} the variants {(got_k1, got_k2)} ran, "
                                 f"expected {(want_k1, want_k2)}")
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
                       "variants": [got_k1, got_k2],
                       "cholesky_rel_err": e1, "cho_solve_rel_err": e2,
                       "broadcast_rel_err": e3, "rel_tol": tol})
        if (B, n, dtype) in TIMED_SHAPES:
            timed[(B, n, dtype)] = kernel_times(K, b, L_plain, x, x_plain, L)
    check_nan_contracts()
    one = torch.zeros(1, device=DEVICE)
    launch_floor = event_ms(lambda: one.add_(1))
    emit("kernels", kernels=["lane_cholesky", "lane_cho_solve"], checks=checks,
         nan_contracts=True, launch_floor_ms=launch_floor,
         cho_solve_ms_by_batch=solve_batch_scan(),
         timed={f"{B}x{n}_{str(dt).replace('torch.', '')}": v
                for (B, n, dt), v in timed.items()})
    return timed, launch_floor


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
    bl.reset_launches()
    bs.solver.host_syncs = 0
    bs.solver.outer_iterations = 0


def phase_sweep(name: str, lane_kkt: bool, degrees=DEGREES, batch=BATCH,
                reference=REFERENCE_OBJECTIVES, expect=None):
    """One sweep, its counted run and its checks: on the lane route both
    kernels must run their shared variants only, and ``expect`` maps fields
    of the phase's line (iters_p50, first_iterations, launches, host_syncs)
    to the values they must take."""
    problem = brachistochrone.make_problem(degrees=degrees)
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=lane_kkt))
    bs = make_batch_solver(problem, options)          # device=None: the GPU
    args = sweep_inputs(bs, batch)

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
    launches = {k: getattr(bl, k).launches for k in ("lane_cholesky", "lane_cho_solve")}
    by_variant = {k: {v: getattr(getattr(bl, k), f"launches_{v}") for v in ("shared", "global")}
                  for k in launches}
    host_syncs, outer = bs.solver.host_syncs, bs.solver.outer_iterations

    status = res.status.cpu().numpy()
    objective = res.objective.cpu().numpy()
    iterations = res.iterations.cpu().numpy()
    solved_frac = float(np.mean(status == SOLVED))
    if res.z.shape != (batch, bs.n) or not np.all(np.isfinite(objective)):
        raise AssertionError(f"{name}: result has a wrong shape or non-finite objectives")
    if solved_frac != 1.0:
        raise AssertionError(f"{name}: solved_frac {solved_frac} != 1.0")
    nref = len(reference)
    obj_err = float(np.max(np.abs(objective[:nref] - np.asarray(reference))))
    if not obj_err <= OBJECTIVE_TOL:
        raise AssertionError(
            f"{name}: first {nref} objectives differ from the reference by {obj_err}")
    if lane_kkt:
        for k in ("lane_cholesky", "lane_cho_solve"):
            if not (by_variant[k]["shared"] > 0 and by_variant[k]["shared"] == launches[k]):
                raise AssertionError(
                    f"{name}: {k} did not run (only) its shared variant: {by_variant[k]}")
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

    got = {"iters_p50": int(np.median(iterations)),
           "first_iterations": iterations[:nref].tolist(), "launches": launches,
           "host_syncs": host_syncs}
    for key, want in (expect or {}).items():
        if got[key] != want:
            raise AssertionError(f"{name}: {key} is {got[key]}, expected {want}")

    wall = statistics.median(walls)
    emit(name, lane_kkt=lane_kkt, batch=batch, n=bs.n, m=bs.m,
         solved_frac=solved_frac, wall_s=wall, wall_s_runs=walls, warmup_s=warm_s,
         solves_per_s=batch * solved_frac / wall,
         iters_p50=int(np.median(iterations)), iters_max=int(iterations.max()),
         outer_iterations=outer, launches=launches, launches_by_variant=by_variant,
         launches_per_solve={k: v / batch for k, v in launches.items()},
         host_syncs=host_syncs, host_syncs_per_iteration=host_syncs / max(outer, 1),
         first_objectives_max_err=obj_err, objectives_compared=nref,
         first_iterations=iterations[:nref].tolist(),
         nominal_tf=tf, nominal_tf_err=tf_err, nominal_iterations=int(res1.iterations[0]))
    return launches, by_variant


def main():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    log = build.build("batched_linalg", extra_flags=("-Xptxas", "-v"))
    bl._library()                                      # load and bind
    emit("build", seconds=time.perf_counter() - t0, library=build.library_path("batched_linalg"),
         ptxas=ptxas_summary(log))

    timed, launch_floor = phase_kernels()
    launches, by_variant = phase_sweep("sweep_lane", lane_kkt=True, expect=EXPECT_LANE)
    phase_sweep("sweep_apply", lane_kkt=False)
    _, by_variant_large = phase_sweep(
        "sweep_lane_large", lane_kkt=True, degrees=DEGREES_LARGE, batch=BATCH_LARGE,
        reference=REFERENCE_OBJECTIVES_LARGE, expect=EXPECT_LANE_LARGE)

    source = "lpopc_tpu_torch/csrc/batched_linalg.cu"
    replaces = {"lane_cholesky": "lpopc_tpu/ops/batched_linalg.py:128",
                "lane_cho_solve": "lpopc_tpu/ops/batched_linalg.py:193"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source, "replaces": replaces[k],
         "launches": launches[k], **timed[MAIN_SHAPE][k],
         "launches_by_variant": {"sweep_lane": by_variant[k],
                                 "sweep_lane_large": by_variant_large[k]},
         "launch_floor_ms": launch_floor,
         "at_shapes": [{"B": B, "n": n, "dtype": str(dt).replace("torch.", ""), **timed[
             (B, n, dt)][k]} for (B, n, dt) in TIMED_SHAPES if (B, n, dt) != MAIN_SHAPE]}
        for k in ("lane_cholesky", "lane_cho_solve")
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
