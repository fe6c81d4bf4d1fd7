"""The comparison that decides ``correct``.

The plain reference (``reference/ocp.py`` and the configuration's problem
file) transcribes each instance again, with the perturbations the benchmark
drew, and reads the program's answers only to judge them; the traffic's
mode (``modes/<mode>.py``, ``numbers``) gives per instance:

- ``unsolved``: the share of the window's instances (sweep) or solves (hp)
  that never came: not solved to tolerance (status SOLVED), or in an hp
  solve not to the mesh tolerance by its own final estimate;
- ``primal``, ``dual``, ``objective``: the worst over every answer the
  program counts solved (``ocp.Transcription.numbers``): a claim of a
  solution is held to what it claims, and an answer that never came counts
  in ``unsolved`` alone;
- hp only: ``mesh_error``, the reference's own estimate of each final
  mesh's discretization error (its limit is the configuration's
  ``desired_relative_error``), and ``mesh_error_gap``, its relative gap to
  the estimate the program reports.

The cell's limits file names the numbers it compares and their limits;
``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import numpy as np


def deltas(perturbations):
    """One call's perturbations as the reference's ``bounds`` takes them."""
    return [(p.point, list(p.states), p.delta) for p in perturbations]


def readings(per_instance: dict, every_answer: bool = False) -> dict:
    """The numbers from per-instance ones: the unsolved share, and the
    worst of each other number over the instances counted solved (0 where
    none is); ``every_answer``: over every answer, whatever its status."""
    solved = per_instance["solved"]
    out = {"unsolved": float(1.0 - solved.mean()) if solved.size else 1.0}
    pick = np.ones_like(solved, dtype=bool) if every_answer else solved.astype(bool)
    out.update({k: float(v[pick].max()) if pick.any() else 0.0
                for k, v in per_instance.items() if k != "solved"})
    return out


def decide(cell, values: dict):
    """(correct, checks): each number the cell's limits file names, beside
    its limit; correct when none is over its limit."""
    checks = {k: {"value": values[k], "limit": float(spec["limit"])}
              for k, spec in cell.limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
