"""ASCII result artifacts, diffable against the reference's output files.

The reference dumps ``time<p> / state<p> / control<p> / parameter<p> /
costate<p> / Hamiltonian<p>`` per phase after the final grid
(``Lpopc/src/Core/Nlp2OPConverter.cpp:198-223``; formats in
``doc/LpopcDoc.tex:1190-1202``). Same artifact family here, so a reference
user can diff trajectories file-by-file. Counterpart of the JAX package's
``utils/resultfiles.py``: a :class:`..core.postprocess.Solution` holds host
numpy arrays, so the files are the same, byte for byte in layout.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.postprocess import Solution


def save_results(sol: Solution, directory: str, prefix: str = "") -> list:
    """Write the reference-style result file family; returns written paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []

    def dump(name, arr):
        path = os.path.join(directory, f"{prefix}{name}.dat")
        arr = np.asarray(arr)
        if arr.ndim < 2:
            arr = arr.reshape(-1, 1)  # one row per trajectory point
        np.savetxt(path, arr, fmt="%.16e")
        paths.append(path)

    for p, ps in enumerate(sol.phases, start=1):
        dump(f"time{p}", ps.t_state)
        dump(f"state{p}", ps.x)
        dump(f"control{p}", ps.u_full)
        dump(f"parameter{p}", ps.q if ps.q.size else np.zeros((1,)))
        dump(f"costate{p}", np.vstack([ps.costate, ps.costate_f[None, :]]))
        dump(f"Hamiltonian{p}", ps.hamiltonian)
    summary = os.path.join(directory, f"{prefix}summary.txt")
    with open(summary, "w") as f:
        f.write(
            f"status {sol.status}\nobjective {sol.objective:.16e}\n"
            f"kkt_error {sol.kkt_error:.3e}\ngrids {sol.grids}\n"
            f"max_relative_error {sol.max_relative_error:.3e}\n"
        )
        for p, ps in enumerate(sol.phases, start=1):
            f.write(
                f"phase{p} t0 {ps.t0:.12g} tf {ps.tf:.12g} "
                f"segments {len(ps.mesh_degrees)} "
                f"degrees {list(ps.mesh_degrees)}\n"
            )
        # refinement trajectory (the reference's per-grid observability is
        # file-per-grid; one combined history line per grid here)
        hist = getattr(sol, "mesh_history", None) or []
        errs = getattr(sol, "error_history", None) or []
        for k, sig in enumerate(hist, start=1):
            line = f"grid {k} mesh {sig}"
            if k - 1 < len(errs):
                emax = max(
                    (float(np.max(e)) if np.asarray(e).size else 0.0)
                    for e in errs[k - 1]
                )
                line += f" max_error {emax:.3e}"
            f.write(line + "\n")
    paths.append(summary)
    return paths
