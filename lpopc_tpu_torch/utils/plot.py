"""Trajectory plotting — the reference validates against plots in its manual
(``doc/LpopcDoc.tex:1290-1426``); this helper produces the matching figures.

matplotlib is imported inside :func:`plot_solution`, never with the module:
the solver does not need it.
"""

from __future__ import annotations

import os
import sys


def plot_solution(sol, path: str = None, show_costates: bool = True):
    """One figure per phase: states, controls, and (optionally) costates.
    Returns the matplotlib figure list; saves to ``path`` (png) if given."""
    import matplotlib

    if "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg")  # headless default; don't clobber a chosen backend
    import matplotlib.pyplot as plt

    figs = []
    for p, ps in enumerate(sol.phases):
        rows = 3 if show_costates else 2
        fig, axes = plt.subplots(rows, 1, figsize=(8, 3 * rows), sharex=True)
        axes[0].plot(ps.t_state, ps.x, ".-")
        axes[0].set_ylabel("states")
        axes[0].legend([f"x{i+1}" for i in range(ps.x.shape[1])], fontsize=8)
        if ps.u.shape[1]:
            axes[1].plot(ps.t_col, ps.u, ".-")
        axes[1].set_ylabel("controls")
        if show_costates:
            axes[2].plot(ps.t_col, ps.costate, ".-")
            axes[2].set_ylabel("costates")
            axes[2].set_xlabel("t")
        fig.suptitle(f"phase {p + 1} (J = {sol.objective:.6g}, status {sol.status})")
        fig.tight_layout()
        figs.append(fig)
        if path:
            if len(sol.phases) == 1:
                out = path
            else:
                stem, ext = os.path.splitext(path)
                out = f"{stem}_phase{p + 1}{ext or '.png'}"
            fig.savefig(out, dpi=120)
    return figs
