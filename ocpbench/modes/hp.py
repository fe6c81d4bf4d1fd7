"""Mode ``hp``: ``core/solve.py::solve`` from the traffic's first mesh; a
call is one hp-adaptive solve of one instance.

A solve counts as solved only where it ends with status SOLVED and its own
final error estimate at most the configuration's
``desired_relative_error``: the solve hands back its last grid's answer
with status SOLVED also where refinement stopped short of the tolerance."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ocpbench import judge, program
from ocpbench.reference import ocp


def converged(status: int, error: float, tolerance: float) -> bool:
    return status == program.SOLVED and error <= tolerance


class Program:
    def __init__(self, config: dict, traffic: dict, device, dtype):
        from lpopc_tpu_torch.utils.device import resolve_device

        self.problem = program.problem(config, traffic)
        self.options = program.options(config, traffic)
        self.device, self.dtype = resolve_device(device), dtype

    def inputs(self, perturbations):
        """The problem with its pinned boundary states moved (and its guess's
        end points with them)."""
        phases = list(self.problem.phases)
        for p in perturbations:
            ph = phases[p.phase]
            key, row = ("x0_bounds", 0) if p.point == "x0" else ("xf_bounds", -1)
            lo, hi = (np.array(b, float).reshape(-1) for b in getattr(ph, key))
            gx = np.array(ph.guess_x, float)
            for j, s in enumerate(p.states):
                lo[s] += p.delta[0, j]
                hi[s] += p.delta[0, j]
                gx[row, s] += p.delta[0, j]
            phases[p.phase] = dataclasses.replace(ph, **{key: (lo, hi)}, guess_x=gx)
        return dataclasses.replace(self.problem, phases=tuple(phases))

    def run(self, problem):
        from lpopc_tpu_torch.core.solve import solve

        t0 = time.perf_counter()
        sol = solve(problem, self.options, device=self.device, dtype=self.dtype)
        sol.bench_wall_s = time.perf_counter() - t0
        ok = converged(int(sol.status), float(sol.max_relative_error),
                       self.options.desired_relative_error)
        return sol, int(ok)

    def counters(self) -> dict:
        return program.launches()

    def reset_counters(self):
        program.reset_launches()

    def answers(self, results) -> list:
        """One record per solve, in the problem's units; ``phases`` holds
        each phase's final mesh and trajectory."""
        out = []
        for sol in results:
            out.append({
                "status": int(sol.status), "objective": float(sol.objective),
                "z": np.asarray(sol.z, float), "lam": np.asarray(sol.lam, float),
                "phases": [{"x": np.asarray(ph.x, float), "u": np.asarray(ph.u, float),
                            "t0": float(ph.t0), "tf": float(ph.tf),
                            "degrees": tuple(int(d) for d in ph.mesh_degrees),
                            "fractions": np.asarray(ph.mesh_fractions, float)}
                           for ph in sol.phases],
                "mesh_error": float(sol.max_relative_error),
                "tolerance": float(self.options.desired_relative_error),
                "grids": int(sol.grids), "wall_s": float(sol.bench_wall_s),
                "grid_stats": [{"n": int(g["n"]), "wall_s": float(g["wall_s"]),
                                "iterations": int(g["iterations"])} for g in sol.grid_stats],
            })
        return out

    def close(self):
        self.problem = None


def numbers(cell, answers, pool, used) -> dict:
    """Per solve: solved (status SOLVED and its own final error estimate
    within tolerance), the reference's numbers on its final mesh,
    ``mesh_error`` (the reference's own estimate of that mesh's error) and
    ``mesh_error_gap`` (the program's estimate against it, relative)."""
    out = {k: [] for k in ("solved", "primal", "dual", "objective", "mesh_error",
                           "mesh_error_gap")}
    for rec, k in zip(answers, used):
        tr = ocp.transcription(cell.reference, rec)
        zl, zu, cl, cu = tr.bounds(judge.deltas(pool[k]), 1)
        nums = tr.numbers(rec["z"][None], rec["lam"][None], np.array([rec["objective"]]),
                          zl, zu, cl, cu)
        err = ocp.mesh_error(cell.reference, rec)
        out["solved"].append(converged(rec["status"], rec["mesh_error"], rec["tolerance"]))
        for name in ("primal", "dual", "objective"):
            out[name].append(float(nums[name][0]))
        out["mesh_error"].append(err if np.isfinite(err) else np.inf)
        gap = abs(rec["mesh_error"] - err) / err if err > 0 else np.inf
        out["mesh_error_gap"].append(gap if np.isfinite(gap) else np.inf)
    return {k: np.asarray(v) for k, v in out.items()}
