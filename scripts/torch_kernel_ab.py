#!/usr/bin/env python3
"""Time two versions of the batched Cholesky (K1) and Cholesky-solve (K2)
kernels against each other on one GPU, in turns.

    python3 scripts/torch_kernel_ab.py OTHER_CU [--rounds 5]

OTHER_CU is another version of ``lpopc_tpu_torch/csrc/batched_linalg.cu``,
e.g. a parent commit's, unpacked with ``git archive`` into a git-ignored
directory. Both sources are built with the package's nvcc flags and called
through the C ABI they share (``lpopc_lane_cholesky_f64``,
``lpopc_lane_cho_solve_f64``) on the same inputs at the sweep's shape
(B = 512, n = 53, f64), so the Python around the launch is the same for
both. Each round runs other, this, this, other; each reading is
``chip_smoke.event_ms`` (device time per launch, launches back to back).
Prints the card's name and power limit, then one JSON line. Needs one CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (exits at once without a CUDA device)
from lpopc_tpu_torch.utils import build  # noqa: E402

B, N = 512, 53


def bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lpopc_lane_cholesky_f64.argtypes = [vp, vp, i32, i32, i64, vp]
    lib.lpopc_lane_cholesky_f64.restype = i32
    lib.lpopc_lane_cho_solve_f64.argtypes = [vp, vp, vp, i32, i32, i64, i64, vp]
    lib.lpopc_lane_cho_solve_f64.restype = i32
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_cu")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    other_so = os.path.join(os.path.dirname(os.path.abspath(args.other_cu)), "liblpopc_ab_other.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", other_so, args.other_cu],
                   check=True, timeout=600)
    build.build("batched_linalg")
    libs = {"other": bind(other_so), "this": bind(build.library_path("batched_linalg"))}

    K, b = cs.spd_batch(B, N, torch.float64, seed=B * 1000 + N)
    L = torch.linalg.cholesky(K)
    outs = {k: (torch.empty_like(K), torch.empty_like(b)) for k in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def k1(name):
        lib, (Lo, _) = libs[name], outs[name]
        return lambda: lib.lpopc_lane_cholesky_f64(K.data_ptr(), Lo.data_ptr(), B, N,
                                                   K.stride(0), stream)

    def k2(name):
        lib, (_, xo) = libs[name], outs[name]
        return lambda: lib.lpopc_lane_cho_solve_f64(L.data_ptr(), b.data_ptr(), xo.data_ptr(),
                                                    B, N, L.stride(0), b.stride(0), stream)

    for name in libs:
        if k1(name)() or k2(name)():
            raise RuntimeError(f"{name}: launch failed")
    torch.cuda.synchronize()
    agree = {
        "lane_cholesky": float((outs["this"][0] - outs["other"][0]).abs().max()),
        "lane_cho_solve": float((outs["this"][1] - outs["other"][1]).abs().max()),
    }
    if not max(agree.values()) <= 1e-10:
        raise AssertionError(f"the two versions disagree: {agree}")

    ms = {kern: {"other": [], "this": []} for kern in ("lane_cholesky", "lane_cho_solve")}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            ms["lane_cholesky"][name].append(cs.event_ms(k1(name)))
            ms["lane_cho_solve"][name].append(cs.event_ms(k2(name)))
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({
        "shape": [B, N, "float64"], "rounds": args.rounds, "max_abs_diff": agree,
        "ms": ms,
        "median_ms": {k: {s: statistics.median(v) for s, v in d.items()} for k, d in ms.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
