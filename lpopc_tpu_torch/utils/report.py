"""Combined human-readable solve report.

The reference's observability surface is spread over three artifact
families: the main log ``lpopc-main-msg.txt`` (banner + problem info +
per-segment refine verdicts, ``LpLpopcApplication.cpp:101-122``,
``LpLpopcAlgorithm.cpp:264-345``), per-grid IPOPT logs
``grid-<k>Ipopt-out.txt`` (``LpNLPSolver.cpp:24-29``), and the result-file
family (``Nlp2OPConverter.cpp:198-223``). Here the per-grid iteration traces
live in ``SolveOptions.iteration_log_dir`` and the trajectories in
:mod:`.resultfiles`; this module renders the ONE summary the reference
never had — every NLP solve of the hp loop (size, status, iterations, KKT,
wall, mesh, measured error) plus the refinement trajectory and the final
verdict in a single diffable text block. The text is the JAX package's
(``utils/report.py``) line for line, so reports of the two packages diff
cleanly; only the timings differ.
"""

from __future__ import annotations

import os

import numpy as np

_STATUS = {
    1: "SOLVED",
    2: "MAX_ITER",
    3: "NLP_FAILED",
    4: "RESTORATION_FAILED",
    5: "REACH_MAX_GRID",
}


def _status_name(code: int) -> str:
    return _STATUS.get(int(code), f"STATUS_{int(code)}")


def format_report(sol, problem=None, options=None) -> str:
    """Render the combined solve report for a :class:`Solution`."""
    lines = []
    add = lines.append
    add("=" * 72)
    add("lpopc_tpu solve report")
    add("=" * 72)
    if problem is not None:
        from ..core.solve import describe_problem

        add(describe_problem(problem, options).rstrip())
        add("-" * 72)

    stats = getattr(sol, "grid_stats", None) or []
    if stats:
        add("NLP solves (hp loop):")
        add(
            f"  {'grid':>4} {'n':>6} {'m':>6} {'status':>16} {'iters':>5} "
            f"{'kkt':>9} {'objective':>18} {'wall_s':>8} {'mesh_err':>9}  note"
        )
        for row in stats:
            err = row.get("max_error")
            err_s = f"{err:9.2e}" if err is not None else " " * 9
            add(
                f"  {row['grid']:>4} {row['n']:>6} {row['m']:>6} "
                f"{_status_name(row['status']):>16} {row['iterations']:>5} "
                f"{row['kkt_error']:9.2e} {row['objective']:18.10e} "
                f"{row['wall_s']:8.3f} {err_s}  {row.get('note', '')}"
            )
        total_wall = sum(r["wall_s"] for r in stats if np.isfinite(r["wall_s"]))
        total_iters = sum(r["iterations"] for r in stats)
        add(f"  total: {len(stats)} NLP solves, {total_iters} IPM iterations, "
            f"{total_wall:.3f} s")
        add("-" * 72)

    hist = getattr(sol, "mesh_history", None) or []
    if hist:
        add("mesh refinement history:")
        errs_hist = getattr(sol, "error_history", None) or []
        for k, sig in enumerate(hist, start=1):
            line = f"  grid {k}: {sig}"
            if k - 1 < len(errs_hist):
                emax = max(
                    (float(np.max(e)) if np.asarray(e).size else 0.0)
                    for e in errs_hist[k - 1]
                )
                line += f"  max_error {emax:.3e}"
            add(line)
        add("-" * 72)

    add(f"status            {_status_name(sol.status)} ({sol.status})")
    add(f"objective         {sol.objective:.16e}")
    add(f"kkt_error         {sol.kkt_error:.3e}")
    add(f"grids             {sol.grids}")
    mre = getattr(sol, "max_relative_error", np.nan)
    add(f"max_relative_err  {mre:.3e}")
    pv = getattr(sol, "path_violation", np.nan)
    if np.isfinite(pv):
        add(f"internode_viol    {pv:.3e}  (max path/bound excursion between "
            "collocation nodes)")
    if getattr(sol, "polish_failed", False):
        add("WARNING           final full-tolerance polish failed; "
            "kkt_error above the requested NLP tolerance")
    for p, ps in enumerate(sol.phases, start=1):
        add(
            f"phase {p}:  t0 {ps.t0:.12g}  tf {ps.tf:.12g}  "
            f"segments {len(ps.mesh_degrees)}  "
            f"points {int(sum(ps.mesh_degrees)) + 1}  "
            f"degrees {list(ps.mesh_degrees)}"
        )
    add("=" * 72)
    return "\n".join(lines) + "\n"


def write_report(sol, path: str, problem=None, options=None) -> str:
    """Write :func:`format_report` to ``path``; returns the path."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(format_report(sol, problem=problem, options=options))
    return path
