#!/usr/bin/env python3
"""Per-iteration trace of the port's block-KKT sweep on one device.

Runs ``chip_smoke.py``'s ``sweep_block`` configuration (brachistochrone at
degrees (16,) * 11, n = 709, 64 instances with the terminal target
perturbed from seed 0, ``IPMOptions(tol=1e-8, max_iter=60,
lane_kkt=True)``, the default ``block_kkt="auto"``) under both
``block_assembly`` values with ``record_history=True``, and instances 2, 41
and 45 again each as a batch of one. With ``--jitter K`` it also runs every
instance K times in one batch, copy 0 as it is and copies 1..K-1 with the
starting point scaled by 1 + 1e-15·U(-1, 1) (seed 1): a spread of counts
there shows that rounding decides that instance's count. Writes one JSON
file: the per-instance iterations of every run and the IPM history (kkt, mu,
theta, alpha, delta_w, reg_k, ls_iters, lin_err, r0, r_end per iteration) of
those three instances.
``scripts/jax_block_pins.py sweep_trace`` prints the JAX package's twin;
the two files show where a trajectory leaves another's.

Usage (from the repository root):

    python3 scripts/torch_block_trace.py --device cuda --out trace_cuda.json
    python3 scripts/torch_block_trace.py --device cpu --out trace_cpu.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpopc_tpu_torch.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu_torch.core.solve import SolveOptions  # noqa: E402
from lpopc_tpu_torch.models import brachistochrone  # noqa: E402
from lpopc_tpu_torch.parallel.batch import make_batch_solver  # noqa: E402

BATCH = 64
INSTANCES = (2, 41, 45)
KEYS = ("kkt", "mu", "theta", "alpha", "alpha_max", "delta_w", "reg_k", "ls_iters",
        "lin_err", "dphi", "step_inf", "r0", "r_end")


def sweep_inputs(bs, batch, seed=0):
    """chip_smoke.py's perturbation: the terminal target, 0.2·U(-1, 1)·var_scale."""
    rng = np.random.default_rng(seed)
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    rows = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (batch, 2)) * bs.scaled.var_scale[rows][None, :]
    zl[:, rows] += pert
    zu[:, rows] += pert
    return z0, zl, zu, cl, cu


def traced(res, instances, rows=None):
    it = res.iterations.cpu().tolist()
    hist = {k: v.cpu().numpy() for k, v in res.history.items()}
    rows = rows if rows is not None else instances
    return {"iterations": it, "history": {
        str(i): {k: hist[k][r, : it[r]].tolist() for k in KEYS if k in hist}
        for i, r in zip(instances, rows)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jitter", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    problem = brachistochrone.make_problem(degrees=(16,) * 11)
    base = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=True,
                                       record_history=True))
    out = {"device": args.device, "batch": BATCH, "instances": INSTANCES,
           "torch": torch.__version__}
    if args.device.startswith("cuda"):
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    for assembly in ("direct", "dense"):
        bs = make_batch_solver(problem, replace(base, block_assembly=assembly),
                               device=args.device)
        inputs = sweep_inputs(bs, BATCH)
        out[assembly] = traced(bs.run(*inputs), INSTANCES)
        out[assembly + "_alone"] = {
            str(i): traced(bs.run(*(a[i : i + 1] for a in inputs)), [i], [0])
            for i in INSTANCES}
        print(assembly, "iterations", out[assembly]["iterations"], flush=True)
        print(assembly, "alone", {i: r["iterations"][0]
                                  for i, r in out[assembly + "_alone"].items()}, flush=True)
        if args.jitter:
            k = args.jitter
            rep = [np.repeat(a, k, axis=0) for a in inputs]
            eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
            eps[::k] = 0.0
            rep[0] = rep[0] * (1.0 + eps)
            it = bs.run(*rep).iterations.cpu().numpy().reshape(BATCH, k)
            out["jitter_" + assembly] = it.tolist()
            spread = {i: sorted(set(row)) for i, row in enumerate(it.tolist())
                      if len(set(row)) > 1}
            print(assembly, f"jitter x{k}: instances whose count moves", spread, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
