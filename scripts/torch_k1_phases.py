#!/usr/bin/env python3
"""Where K1 (the batched Cholesky) spends its time, on one GPU.

    python3 scripts/torch_k1_phases.py

Builds ``lpopc_tpu_torch/csrc/batched_linalg.cu`` with ``-DLPOPC_K1_PROBE``
(into the git-ignored ``lpopc_tpu_torch/build/``), which compiles in the
kernel's own probe points: thread 0 of each block of
``lane_cholesky_kernel<double>`` reads ``clock64()`` at the end of each
phase. The segments are the copy of panel 0's columns (``issue``: copies
issued; ``load``: landed and the first barrier passed), per panel p the
loads of the tile and rows (``ax``), the panel step (``step``), the barrier
after it (``bar``: the wait for the other warps) and the trailing update
with its barrier (``update``), then the store of the last column block
(``store``). Each segment is the mean over the blocks of one launch (clocks
of different SMs are not compared). Then the device time of each kernel of
K1's global variant at (8, 700, f64), by ``torch.profiler`` over 5 calls
(copy, panel step, trailing update).

Prints the card's name, power limit and SM clock, then one JSON line per
measurement. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits at once without a CUDA device)
from lpopc_tpu_torch.ops import batched_linalg as bl  # noqa: E402
from lpopc_tpu_torch.utils import build  # noqa: E402


def build_probed() -> ctypes.CDLL:
    os.makedirs(build.build_dir(), exist_ok=True)
    so = os.path.join(build.build_dir(), "libk1_phases.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DLPOPC_K1_PROBE", "-o", so,
                    build.source_path("batched_linalg")], check=True, timeout=600)
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lpopc_lane_cholesky_f64.argtypes = [vp, vp, i32, i32, i64, vp]
    lib.lpopc_k1_probe_buffer.argtypes = [vp, vp]
    return lib


def emit(**fields):
    print(json.dumps(fields), flush=True)


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = build_probed()
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda", 0)

    for B, n in ((1, 53), (512, 53), (1, 197), (64, 197)):
        K, _ = cs.spd_batch(B, n, torch.float64, seed=B * 1000 + n)
        L = torch.empty_like(K)
        prof = torch.zeros(B, 64, dtype=torch.int64, device=dev)
        if lib.lpopc_k1_probe_buffer(prof.data_ptr(), stream):
            raise RuntimeError("probed K1: setting the probe buffer failed")

        def run():
            if lib.lpopc_lane_cholesky_f64(K.data_ptr(), L.data_ptr(), B, n, K.stride(0), stream):
                raise RuntimeError("probed K1: launch failed")

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        err = cs.rel_err(L, bl.lane_cholesky_plain(K))
        if not err <= cs.REL_TOL[torch.float64]:
            raise AssertionError(f"probed K1 disagrees with the plain version: {err}")
        p = prof.cpu().numpy().astype(np.float64)
        panels = (n + 31) // 32
        idx = [0, 60, 1] + [k for q in range(panels)
                            for k in (40 + q, 2 + 3 * q, 3 + 3 * q, 4 + 3 * q)] + [63]
        names = ["issue", "load"] + [f"{w}{q}" for q in range(panels)
                                     for w in ("ax", "step", "bar", "update")] + ["store"]
        seg = np.diff(p[:, idx], axis=1).mean(0)
        emit(probe="lane_cholesky_f64_phases", B=B, n=n, rel_err=err,
             ms=cs.event_ms(run), total_cycles=float((p[:, 63] - p[:, 0]).mean()),
             segments={k: round(float(v)) for k, v in zip(names, seg)})

    from torch.profiler import ProfilerActivity, profile
    K, _ = cs.spd_batch(8, 700, torch.float64, seed=8 * 1000 + 700)
    calls = 5
    for _ in range(3):
        bl.lane_cholesky(K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(calls):
            bl.lane_cholesky(K)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in trace.key_averages():
        if "cholesky" in ev.key and ev.device_time_total > 0:
            name = ev.key.split("::")[-1].split("(")[0]
            per_kernel[name] = {"launches_per_call": ev.count / calls,
                                "us_per_call": ev.device_time_total / calls,
                                "us_per_launch": ev.device_time_total / ev.count}
    if not per_kernel:
        raise RuntimeError("the profiler saw no device time for K1's global variant")
    emit(probe="lane_cholesky_global_kernels", B=8, n=700, per_kernel=per_kernel,
         ms=cs.event_ms(lambda: bl.lane_cholesky(K)))


if __name__ == "__main__":
    main()
