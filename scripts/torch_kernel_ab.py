#!/usr/bin/env python3
"""Time two versions of the batched Cholesky (K1) and Cholesky-solve (K2)
kernels against each other on one GPU, in turns.

    python3 scripts/torch_kernel_ab.py OTHER_CU [--rounds 5] [--other-k1-scratch]

OTHER_CU is another version of ``lpopc_tpu_torch/csrc/batched_linalg.cu``,
e.g. a parent commit's, unpacked with ``git archive`` into a git-ignored
directory. Each tree's ``.cu`` is built with the package's nvcc flags, and
its ``batched_linalg_layout.cpp`` (beside the ``.cu``) with g++; each tree's
own layout rule then picks the entry point (shared or global variant) that
it calls at each shape. Every entry point is called with this tree's C
signature, but for ``--other-k1-scratch``: the other tree's global K1 then
takes a (B, n) scratch column (versions before the blocked panel
kernels). Global K2 has kept its C signature, but not what its scratch
holds: each call gets a scratch buffer large enough for either tree's
(the one-warp version's (B, n) reciprocals, this tree's counters). K1 is
timed at (B, n) = (512, 53), (64, 197) and (8, 700) in f64, K2 at
(512, 53), (1, 515), (8, 700), (512, 300) and (1, 4099) (the sweep's
shape, the hp solve's grids at B = 1, and a grid of several waves of
blocks); the inputs are the same for both, and the two outputs must agree
to 1e-10 relative. Each round runs other, this, this, other; each reading
is ``chip_smoke.event_ms`` (device time per launch, launches back to
back; 10 launches a batch past n = 2000). Prints the card's name and power
limit, then one JSON line. Needs one CUDA device, nvcc and g++.
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
from lpopc_tpu_torch.ops import batched_linalg as bl  # noqa: E402
from lpopc_tpu_torch.utils import build  # noqa: E402

K1_SHAPES = ((512, 53), (64, 197), (8, 700))
K2_SHAPES = ((512, 53), (1, 515), (8, 700), (512, 300), (1, 4099))
VARIANTS = ("shared", "global")


class Tree:
    """One version's kernel library, its layout rule, and its K1 ABI."""

    def __init__(self, so_path: str, layout_so: str, k1_scratch: bool = False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib = ctypes.CDLL(so_path)
        self.scratch = k1_scratch
        self.lib.lpopc_lane_cholesky_f64.argtypes = [vp, vp, i32, i32, i64, vp]
        self.lib.lpopc_lane_cholesky_global_f64.argtypes = (
            [vp, vp, vp, i32, i32, i64, vp] if self.scratch else [vp, vp, i32, i32, i64, vp])
        self.lib.lpopc_lane_cho_solve_f64.argtypes = [vp, vp, vp, i32, i32, i64, i64, vp]
        self.lib.lpopc_lane_cho_solve_global_f64.argtypes = [vp, vp, vp, vp, i32, i32, i64, i64,
                                                             vp]
        for f in (self.lib.lpopc_lane_cholesky_f64, self.lib.lpopc_lane_cholesky_global_f64,
                  self.lib.lpopc_lane_cho_solve_f64, self.lib.lpopc_lane_cho_solve_global_f64):
            f.restype = i32
        self.layout = ctypes.CDLL(layout_so)
        for kernel in ("lane_cholesky", "lane_cho_solve"):
            f = getattr(self.layout, f"lpopc_{kernel}_variant")
            f.argtypes = [i32, i32]
            f.restype = i32

    def k1(self, K, L, stream):
        """A zero-argument launcher of K1 at K's shape, and its variant."""
        B, n, _ = K.shape
        which = VARIANTS[self.layout.lpopc_lane_cholesky_variant(n, 8)]
        if which == "shared":
            f = self.lib.lpopc_lane_cholesky_f64
            return (lambda: f(K.data_ptr(), L.data_ptr(), B, n, K.stride(0), stream)), which
        f = self.lib.lpopc_lane_cholesky_global_f64
        if self.scratch:
            col = torch.empty((B, n), dtype=K.dtype, device=K.device)
            return (lambda: f(K.data_ptr(), L.data_ptr(), col.data_ptr(), B, n, K.stride(0),
                              stream)), which
        return (lambda: f(K.data_ptr(), L.data_ptr(), B, n, K.stride(0), stream)), which

    def k2(self, L, b, x, stream):
        """A zero-argument launcher of K2 at L's shape, and its variant."""
        B, n, _ = L.shape
        which = VARIANTS[self.layout.lpopc_lane_cho_solve_variant(n, 8)]
        if which == "shared":
            f = self.lib.lpopc_lane_cho_solve_f64
            return (lambda: f(L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, L.stride(0),
                              b.stride(0), stream)), which
        f = self.lib.lpopc_lane_cho_solve_global_f64
        scratch = torch.empty(B * n * 8 + bl.global_scratch_bytes(B), dtype=torch.uint8,
                              device=L.device)
        return (lambda: f(L.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n,
                          L.stride(0), b.stride(0), stream)), which


def build_other(cu_path: str):
    d = os.path.dirname(os.path.abspath(cu_path))
    so = os.path.join(d, "liblpopc_ab_other.so")
    layout_so = os.path.join(d, "liblpopc_ab_other_layout.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", so, cu_path], check=True,
                   timeout=600)
    subprocess.run(["g++", *build.HOST_FLAGS, "-o", layout_so,
                    os.path.join(d, "batched_linalg_layout.cpp")], check=True, timeout=600)
    return so, layout_so


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_cu")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--other-k1-scratch", action="store_true",
                    help="the other tree's global K1 takes a (B, n) scratch column")
    args = ap.parse_args()

    other_so, other_layout = build_other(args.other_cu)
    build.load_library("batched_linalg")
    build.load_library("batched_linalg_layout")
    trees = {
        "other": Tree(other_so, other_layout, args.other_k1_scratch),
        "this": Tree(build.library_path("batched_linalg"),
                     build.library_path("batched_linalg_layout")),
    }
    stream = torch.cuda.current_stream().cuda_stream

    cases = {}          # name -> {tree: (launcher, output)}
    variants = {}
    for B, n in K1_SHAPES:
        K, _ = cs.spd_batch(B, n, torch.float64, seed=B * 1000 + n)
        name = f"lane_cholesky_{B}x{n}"
        cases[name], variants[name] = {}, {}
        for t, tree in trees.items():
            L = torch.empty_like(K)
            fn, which = tree.k1(K, L, stream)
            cases[name][t] = (fn, L)
            variants[name][t] = which
    for B, n in K2_SHAPES:
        Lf, b = cs.random_factor(B, n, seed=B * 1000 + n)
        name = f"lane_cho_solve_{B}x{n}"
        cases[name], variants[name] = {}, {}
        for t, tree in trees.items():
            x = torch.empty_like(b)
            fn, which = tree.k2(Lf, b, x, stream)
            cases[name][t] = (fn, x)
            variants[name][t] = which

    agree = {}
    for name, by_tree in cases.items():
        for t, (fn, _) in by_tree.items():
            if fn():
                raise RuntimeError(f"{name} ({t}): launch failed")
        torch.cuda.synchronize()
        a, o = by_tree["this"][1], by_tree["other"][1]
        agree[name] = float((a - o).abs().max() / o.abs().max())
    if not max(agree.values()) <= 1e-10:
        raise AssertionError(f"the two versions disagree: {agree}")

    ms = {name: {"other": [], "this": []} for name in cases}
    for _ in range(args.rounds):
        for t in ("other", "this", "this", "other"):
            for name, by_tree in cases.items():
                big = by_tree[t][1].shape[-1] > 2000
                ms[name][t].append(cs.event_ms(by_tree[t][0], **(
                    dict(warmup=1, reps=10) if big else {})))
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({
        "dtype": "float64", "rounds": args.rounds, "variants": variants,
        "max_rel_diff": agree, "ms": ms,
        "median_ms": {k: {s: statistics.median(v) for s, v in d.items()} for k, d in ms.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
