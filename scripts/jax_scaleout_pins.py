#!/usr/bin/env python3
"""Print the JAX package's results that the port's scale-out tests pin.

Runs the JAX package (``lpopc_tpu``) on the CPU in float64, unsharded, and
prints one JSON line per case; with ``--write FILE`` it also merges the
cases into the JSON file FILE (``scripts/jax_scaleout_pins.json``, which
``tests/test_torch_scaleout.py`` reads):

* ``segment_b1``: ``tests/test_segment_shard.py``'s reference, the
  unsharded block-KKT solve of ``hypersensitive.make_problem(tf=40.0,
  degrees=(6,) * 16)`` under ``SolveOptions(ipm=IPMOptions(tol=1e-8,
  max_iter=60), mesh_method="none", block_kkt="on")`` through
  ``make_batch_solver`` at its nominal inputs (B = 1): status, iterations,
  objective and z;
* ``hybrid_b4``: ``tests/test_hybrid.py``'s reference, the same problem and
  options at 4 instances whose pinned initial state moves by
  0.05·i·var_scale (i = 0..3);
* ``hybrid_b4_jitter``: ``hybrid_b4`` again 8 times, copy 0 as it is and the
  others with z0 scaled by 1 + 1e-15·U(-1, 1) (seed 1): the iteration
  counts the JAX package itself takes at a rounding-level change of the
  start (the block path's unequilibrated solve lets rounding decide some
  counts);
* ``distributed_b16``: ``tests/distributed_worker.py``'s sweep, the
  brachistochrone at degrees (6, 6) under ``SolveOptions(ipm=IPMOptions(
  tol=1e-8, max_iter=60))``, global batch 16 made of two local shards of 8,
  shard p with its pinned terminal point moved by 0.1·U(-1, 1)·var_scale
  from ``default_rng(42 + p)``: status, iterations, objective and z per
  instance.

Usage (from the repository root; a few minutes, nearly all XLA compiles):

    JAX_PLATFORMS=cpu python3 scripts/jax_scaleout_pins.py [--write FILE] [case ...]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from lpopc_tpu.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu.core.solve import SolveOptions  # noqa: E402
from lpopc_tpu.models import brachistochrone, hypersensitive  # noqa: E402
from lpopc_tpu.parallel.batch import make_batch_solver  # noqa: E402

SEG_DEGREES = (6,) * 16
SEG_TF = 40.0
HYBRID_BATCH = 4
JITTER_COPIES = 8
DIST_BATCH, DIST_PROCS = 16, 2


def seg_options():
    return SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60), mesh_method="none",
                        block_kkt="on")


def seg_solver():
    return make_batch_solver(
        hypersensitive.make_problem(tf=SEG_TF, degrees=SEG_DEGREES), seg_options())


def hybrid_inputs(bs, batch=HYBRID_BATCH):
    """tests/test_hybrid.py's perturbation of the pinned initial state."""
    z0, zl, zu, cl, cu = bs.nominal_inputs(batch)
    pl = bs.nlp.layout.phases[0]
    sl = slice(pl.var_offset, pl.var_offset + 1)
    d = 0.05 * np.arange(batch)[:, None] * bs.scaled.var_scale[sl][None, :]
    zl[:, sl] += d
    zu[:, sl] += d
    z0[:, sl] += d
    return z0, zl, zu, cl, cu


def dist_inputs(bs):
    """tests/distributed_worker.py's local shards, stacked in process order."""
    shards = []
    per = DIST_BATCH // DIST_PROCS
    for pid in range(DIST_PROCS):
        z0, zl, zu, cl, cu = bs.nominal_inputs(per)
        rng = np.random.default_rng(42 + pid)
        pl = bs.nlp.layout.phases[0]
        first = pl.var_offset + (pl.npts - 1) * pl.nx
        xf = slice(first, first + 2)
        pert = 0.1 * rng.uniform(-1, 1, (per, 2)) * bs.scaled.var_scale[xf][None, :]
        zl[:, xf] += pert
        zu[:, xf] += pert
        shards.append((z0, zl, zu, cl, cu))
    return tuple(np.concatenate([s[i] for s in shards]) for i in range(5))


def summary(res):
    return {"status": np.asarray(res.status).tolist(),
            "iterations": np.asarray(res.iterations).tolist(),
            "objective": np.asarray(res.objective).tolist(),
            "z": np.asarray(res.z).tolist()}


def segment_b1():
    bs = seg_solver()
    return {"n": bs.n, "m": bs.m, **summary(bs.run(*bs.nominal_inputs(1)))}


def hybrid_b4():
    bs = seg_solver()
    return {"n": bs.n, "m": bs.m, **summary(bs.run(*hybrid_inputs(bs)))}


def hybrid_b4_jitter():
    bs = seg_solver()
    args = hybrid_inputs(bs)
    rng = np.random.default_rng(1)
    its = []
    for k in range(JITTER_COPIES):
        z0 = args[0] if k == 0 else args[0] * (1 + 1e-15 * rng.uniform(-1, 1, args[0].shape))
        res = bs.run(z0, *args[1:])
        its.append(np.asarray(res.iterations).tolist())
    its = np.asarray(its)
    return {"iterations": its.tolist(),
            "spread": [[int(its[:, i].min()), int(its[:, i].max())]
                       for i in range(its.shape[1])]}


def distributed_b16():
    bs = make_batch_solver(brachistochrone.make_problem(degrees=(6, 6)),
                           SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60)))
    return {"n": bs.n, "m": bs.m, **summary(bs.run(*dist_inputs(bs)))}


CASES = {
    "segment_b1": segment_b1,
    "hybrid_b4": hybrid_b4,
    "hybrid_b4_jitter": hybrid_b4_jitter,
    "distributed_b16": distributed_b16,
}


def main():
    args = sys.argv[1:]
    path = None
    if args[:1] == ["--write"]:
        path, args = args[1], args[2:]
    for name in args or list(CASES):
        line = {"case": name, **CASES[name]()}
        print(json.dumps({k: v for k, v in line.items() if k != "z"}), flush=True)
        if path is not None:
            pins = {}
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    pins = json.load(f)
            pins[name] = {k: v for k, v in line.items() if k != "case"}
            with open(path, "w", encoding="utf-8") as f:
                f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(pins[k])}"
                                            for k in sorted(pins)) + "\n}\n")


if __name__ == "__main__":
    main()
