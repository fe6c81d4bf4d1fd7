#!/usr/bin/env python3
"""The port's own spread where rounding decides, in the multi-phase sweeps.

Runs ``chip_smoke.py``'s ``sweep_launch`` and ``sweep_boostbrake`` setups
(the JAX package's ``bench.py`` sweeps as written there, ``lane_kkt=True``)
with every instance k times in one batch, copy 0 as it is and the other
copies with the starting point scaled by 1 + 1e-15·U(-1, 1) (seed 1) — the
perturbation of ``scripts/jax_multiphase_pins.py launch_jitter`` — and the
unperturbed sweep once more. Prints one JSON line per sweep with the
instances whose status or count moves: the unperturbed status and count,
the counts of the copies, and the relative spread of the solved copies'
objectives.

    python3 scripts/torch_multiphase_jitter.py [--k 8] [sweep ...]   # needs one CUDA device
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits when there is no CUDA device)


def jitter(name: str, k: int) -> dict:
    make, ipm, inputs, batch, _, _ = cs.MULTIPHASE_SWEEPS[name]
    bs = cs.make_batch_solver(make(), cs.SolveOptions(ipm=cs.IPMOptions(**ipm, lane_kkt=True)))
    base = inputs(bs, batch)
    rep = [np.repeat(a, k, axis=0) for a in base]
    eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
    eps[::k] = 0.0
    rep[0] = rep[0] * (1.0 + eps)
    res = bs.run(*rep)
    plain = bs.run(*base)
    its = res.iterations.cpu().numpy().reshape(batch, k)
    sts = res.status.cpu().numpy().reshape(batch, k)
    obj = res.objective.cpu().numpy().reshape(batch, k)
    p_it, p_st = plain.iterations.cpu().numpy(), plain.status.cpu().numpy()
    moving = {}
    for i in range(batch):
        row_it, row_st = np.append(its[i], p_it[i]), np.append(sts[i], p_st[i])
        if row_it.min() == row_it.max() and row_st.min() == row_st.max():
            continue
        solved = obj[i][sts[i] == cs.SOLVED]
        moving[i] = {"plain": [int(p_st[i]), int(p_it[i])], "copies": its[i].tolist(),
                     "statuses": sorted(set(row_st.tolist())),
                     "objective_rel_spread": (float(np.ptp(solved) / abs(solved.mean()))
                                              if solved.size else None)}
    return {"sweep": name, "k": k, "moving": moving}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sweeps", nargs="*", default=list(cs.MULTIPHASE_SWEEPS))
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}),
          flush=True)
    for sweep in args.sweeps:
        print(json.dumps(jitter(sweep, args.k)), flush=True)


if __name__ == "__main__":
    main()
