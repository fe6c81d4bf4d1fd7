"""Mode ``sweep``: ``make_batch_solver`` on the traffic's fixed mesh; a call
is one ``BatchSolver.run`` over ``batch`` instances in lockstep."""

from __future__ import annotations

import numpy as np
import torch

from ocpbench import judge, program
from ocpbench.reference import ocp


class Program:
    def __init__(self, config: dict, traffic: dict, device, dtype):
        from lpopc_tpu_torch.parallel.batch import make_batch_solver

        self.bs = make_batch_solver(program.problem(config, traffic),
                                    program.options(config, traffic), device=device, dtype=dtype)
        self.device, self.dtype = self.bs.device, dtype
        self.batch = int(traffic["batch"])

    def inputs(self, perturbations):
        """The program's (z0, zl, zu, cl, cu) on its device for one call: a
        moved x0 through ``BatchSolver.perturb_x0`` (which moves the guess
        too), a moved xf on its pinned bounds."""
        bs, B = self.bs, self.batch
        layout = bs.nlp.layout
        moved_x0 = {}
        for p in perturbations:
            if p.point == "x0":
                d = moved_x0.setdefault(p.phase, np.zeros((B, layout.phases[p.phase].nx)))
                d[:, list(p.states)] += p.delta
        if len(moved_x0) > 1:
            raise ValueError("perturb_x0 moves the initial state of one phase a call")
        if moved_x0:
            (phase, d), = moved_x0.items()
            z0, zl, zu, cl, cu = bs.perturb_x0(B, phase, d)
        else:
            z0, zl, zu, cl, cu = bs.nominal_inputs(B)
        for p in perturbations:
            if p.point == "xf":
                pl = layout.phases[p.phase]
                rows = pl.var_offset + (pl.npts - 1) * pl.nx + np.asarray(p.states)
                shift = p.delta * bs.scaled.var_scale[rows][None, :]
                zl[:, rows] += shift
                zu[:, rows] += shift
        return tuple(torch.as_tensor(a, device=self.device, dtype=self.dtype)
                     for a in (z0, zl, zu, cl, cu))

    def run(self, args):
        """One call; returns its result and the count of instances solved
        (reading it waits for the device)."""
        res = self.bs.run(*args)
        return res, int((res.status == program.SOLVED).sum())

    def counters(self) -> dict:
        sv = self.bs.solver
        return {"outer_iterations": sv.outer_iterations, "host_syncs": sv.host_syncs,
                **program.launches()}

    def reset_counters(self):
        self.bs.solver.outer_iterations = 0
        self.bs.solver.host_syncs = 0
        program.reset_launches()

    def answers(self, results) -> dict:
        """The answers of ``results`` in the problem's units, stacked:
        ``status``, ``iterations``, ``z``, ``lam``, ``objective``. The
        solver works in scaled units; its own scale vectors bring them back."""
        s = self.bs.scaled
        cat = lambda f: torch.cat([getattr(r, f).detach().to("cpu", torch.float64)
                                   for r in results]).numpy()
        return {"status": cat("status").astype(int), "iterations": cat("iterations").astype(int),
                "z": cat("z") / s.var_scale[None, :],
                "lam": cat("lam") * (s.con_scale / s.obj_scale)[None, :],
                "objective": cat("objective") / s.obj_scale}

    def close(self):
        self.bs = None


def numbers(cell, answers, pool, used) -> dict:
    """Per instance, in call order: solved (status SOLVED) and the
    reference's numbers."""
    tr = ocp.transcription(cell.reference, cell.traffic["mesh"])
    batch = int(cell.traffic["batch"])
    zl, zu = [], []
    for k in used:
        lo, hi, cl, cu = tr.bounds(judge.deltas(pool[k]), batch)
        zl.append(lo)
        zu.append(hi)
    nums = tr.numbers(answers["z"], answers["lam"], answers["objective"],
                      np.concatenate(zl), np.concatenate(zu), cl, cu)
    return {"solved": answers["status"] == program.SOLVED, **nums}
