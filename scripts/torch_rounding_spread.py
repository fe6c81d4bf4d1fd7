#!/usr/bin/env python3
"""The port's own spread where rounding decides a count.

Runs one solve (or sweep rows) k times, copy 0 as it is and the other copies
with the start scaled by 1 + 1e-15·U(-1, 1) (seed 1, drawn in the order
``scripts/jax_singular_pins.py`` draws them, so copy i is the JAX package's
copy i), and prints one JSON line with the statuses, counts and objectives.
Cases:

* ``tumor_rung0``: ``tumor.make_problem_regularized(1e-2)`` under
  ``tumor.auto_options()`` (the first rung of ``tumor.solve_auto()``), its
  guess (``guess_x``, ``guess_u``, ``guess_q``) scaled; JAX's:
  ``jax_singular_pins.py tumor_rung0_jitter``;
* ``goddard_decomposed``: the decomposed problem of
  ``goddard.solve_auto(degrees=(4,) * 4, eps_schedule=(1e-2, 1e-3))``, built
  from the port's own rung-0 solve, under ``goddard.three_phase_options()``,
  its guess scaled; JAX's: ``goddard_decomposed_jitter``;
* ``two_stage``: rows ``--rows`` of ``chip_smoke.py``'s 512-instance
  brachistochrone sweep under ``two_stage=True``, each k times in one batch,
  the start z0 scaled; JAX's: ``two_stage_jitter``.

Usage (from the repository root; ``--device cpu`` runs the plain versions of
the kernels, the default is the GPU; ``--lane`` puts the IPM on the kernel
route, as ``chip_smoke.py`` does):

    python3 scripts/torch_rounding_spread.py tumor_rung0 [--k 12] [--device cuda] [--lane]
    python3 scripts/torch_rounding_spread.py two_stage --rows 65 282 381 --k 32 --lane
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpopc_tpu_torch.core import arcs as arcs_mod  # noqa: E402
from lpopc_tpu_torch.core import solve as solve_mod  # noqa: E402
from lpopc_tpu_torch.core.decompose import decompose_by_arcs  # noqa: E402
from lpopc_tpu_torch.core.ipm import IPMOptions  # noqa: E402
from lpopc_tpu_torch.core.solve import SolveOptions  # noqa: E402
from lpopc_tpu_torch.models import brachistochrone, goddard, tumor  # noqa: E402
from lpopc_tpu_torch.parallel.batch import make_batch_solver  # noqa: E402


def lane(options, on):
    if not on:
        return options
    return dataclasses.replace(options, ipm=dataclasses.replace(options.ipm_options(),
                                                                lane_kkt=True))


def case_problem(case, use_lane, device):
    if case == "tumor_rung0":
        return tumor.make_problem_regularized(1e-2), lane(tumor.auto_options(), use_lane)
    sol = solve_mod.solve(goddard.make_problem_regularized(1e-2, (4,) * 4),
                          lane(goddard.auto_options(), use_lane), device=device)
    psol = sol.phases[0]
    ph0 = goddard.make_problem(regularization=0.0).phases[0]
    arcs = arcs_mod.detect_control_arcs(
        psol.t_col, psol.u[:, 0], 0.0, goddard.T_MAX,
        hu=arcs_mod.switching_function(ph0, psol, device=device))
    arcs_mod.promote_interior_if_affine(
        arcs, arcs_mod.control_affinity(ph0, psol, device=device))
    problem = decompose_by_arcs(goddard.make_problem(regularization=0.0), psol, arcs,
                                device=device)
    return problem, lane(goddard.three_phase_options(), use_lane)


def two_stage_rows(rows, k, use_lane, device):
    """The two-stage sweep's ``rows``, k copies each, in one batch."""
    problem = brachistochrone.make_problem(degrees=(6, 6))
    options = SolveOptions(ipm=IPMOptions(tol=1e-8, max_iter=60, lane_kkt=use_lane))
    bs = make_batch_solver(problem, options, two_stage=True, device=device)
    rng = np.random.default_rng(0)
    z0, zl, zu, cl, cu = bs.nominal_inputs(512)
    pl = bs.nlp.layout.phases[0]
    first = pl.var_offset + (pl.npts - 1) * pl.nx
    xf = slice(first, first + 2)
    pert = 0.2 * rng.uniform(-1, 1, (512, 2)) * bs.scaled.var_scale[xf][None, :]
    zl[:, xf] += pert
    zu[:, xf] += pert
    rep = [np.repeat(a[list(rows)], k, axis=0) for a in (z0, zl, zu, cl, cu)]
    eps = np.random.default_rng(1).uniform(-1e-15, 1e-15, rep[0].shape)
    eps[::k] = 0.0
    rep[0] = rep[0] * (1.0 + eps)
    res = bs.run(*rep)
    return {key: getattr(res, key).cpu().numpy().reshape(len(rows), k).tolist()
            for key in ("status", "iterations", "objective")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("tumor_rung0", "goddard_decomposed", "two_stage"))
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--rows", type=int, nargs="*", default=())
    ap.add_argument("--device", default=None)
    ap.add_argument("--lane", action="store_true")
    a = ap.parse_args()
    device = torch.device(a.device or "cuda")
    out = {"case": a.case, "k": a.k, "lane_kkt": a.lane, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu")}
    if a.case == "two_stage":
        print(json.dumps({**out, "rows": list(a.rows),
                          **two_stage_rows(a.rows, a.k, a.lane, device)}), flush=True)
        return
    problem, options = case_problem(a.case, a.lane, device)
    rng = np.random.default_rng(1)
    out.update(status=[], iterations=[], objective=[], wall_s=[])
    for copy in range(a.k):
        phases = []
        for ph in problem.phases:
            kw = {}
            for name in ("guess_x", "guess_u", "guess_q"):
                g = getattr(ph, name)
                if g is not None:
                    kw[name] = g * (1 + (rng.uniform(-1e-15, 1e-15, g.shape) if copy else 0.0))
            phases.append(dataclasses.replace(ph, **kw))
        t0 = time.perf_counter()
        s = solve_mod.solve(dataclasses.replace(problem, phases=tuple(phases)), options,
                            device=device)
        out["wall_s"].append(time.perf_counter() - t0)
        out["status"].append(int(s.status))
        out["iterations"].append(int(s.iterations))
        out["objective"].append(float(s.objective))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
