#!/usr/bin/env python3
"""Where the time of the port's batched sweep goes, on the GPU.

Runs the 512-instance brachistochrone sweep of ``chip_smoke.py`` (degrees
(6, 6), seed 0) once warm and once under ``torch.profiler``, for both
factorization routes, and prints one JSON line per route: wall seconds, the
number of device kernels launched, the device-busy share (sum of kernel
durations over wall time), and the kernels that take the most device time.
With ``--sweep sweep_launch`` or ``--sweep sweep_boostbrake`` it profiles
that multi-phase sweep of ``chip_smoke.py`` instead, on the kernel route.

    python3 scripts/torch_sweep_profile.py [--sweep NAME]   # needs one CUDA device

Writes the full tables to ``profile_out/torch_sweep_profile_<route>.txt``
(next to the repository root; the directory is git-ignored).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits when there is no CUDA device)
from lpopc_tpu_torch.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu_torch.core.solve import SolveOptions  # noqa: E402
from lpopc_tpu_torch.models import brachistochrone  # noqa: E402
from lpopc_tpu_torch.parallel.batch import make_batch_solver  # noqa: E402


def setup(sweep: str, lane_kkt: bool):
    """The batch solver, its inputs and the batch of a sweep of chip_smoke.py."""
    if sweep == "brachistochrone":
        bs = make_batch_solver(
            brachistochrone.make_problem(degrees=cs.DEGREES),
            SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=lane_kkt)))
        return bs, cs.sweep_inputs(bs, cs.BATCH), cs.BATCH
    make, ipm, inputs, batch, _, _ = cs.MULTIPHASE_SWEEPS[sweep]
    bs = make_batch_solver(make(), SolveOptions(ipm=IPMOptions(**ipm, lane_kkt=lane_kkt)))
    args = tuple(torch.as_tensor(a, device=cs.DEVICE, dtype=torch.float64)
                 for a in inputs(bs, batch))
    return bs, args, batch


def profile_route(lane_kkt: bool, out_dir: str, sweep: str = "brachistochrone") -> dict:
    from torch.profiler import ProfilerActivity, profile

    bs, args, batch = setup(sweep, lane_kkt)
    bs.run(*args)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs.run(*args)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    cs.reset_counters(bs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bs.run(*args)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and str(e.device_type).endswith("CUDA")]
    if not events:   # older field layout: fall back to any event with device time
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events if e.self_device_time_total > 0)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    route = "lane" if lane_kkt else "apply"
    os.makedirs(out_dir, exist_ok=True)
    tag = route if sweep == "brachistochrone" else f"{sweep}_{route}"
    with open(os.path.join(out_dir, f"torch_sweep_profile_{tag}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    return {
        "sweep": sweep, "route": route, "batch": batch, "wall_s": wall_plain,
        "wall_s_under_profiler": wall_prof,
        "outer_iterations": bs.solver.outer_iterations,
        "host_syncs": bs.solver.host_syncs,
        "device_kernels": n_kernels,
        "device_kernels_per_iteration": n_kernels / max(bs.solver.outer_iterations, 1),
        "device_busy_ms": dev_us / 1e3,
        "device_busy_share_of_profiled_wall": dev_us / 1e6 / wall_prof,
        "device_busy_share_of_plain_wall": dev_us / 1e6 / wall_plain,
        "top_kernels": [
            {"name": e.key[:70], "calls": e.count, "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
        # the host side: the operators that take the most CPU time themselves
        "host_ms": sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3,
        "top_host_ops": [
            {"name": e.key[:70], "calls": e.count, "ms": e.self_cpu_time_total / 1e3}
            for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        ],
    }


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "profile_out")
    sweep = sys.argv[sys.argv.index("--sweep") + 1] if "--sweep" in sys.argv else "brachistochrone"
    for lane in ((True, False) if sweep == "brachistochrone" else (True,)):
        print(json.dumps(profile_route(lane, out_dir, sweep)), flush=True)


if __name__ == "__main__":
    main()
