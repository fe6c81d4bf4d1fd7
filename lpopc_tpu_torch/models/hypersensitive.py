"""Hyper-sensitive problem (reference example #1, Rao 2000).

``min 1/2 ∫ (x² + u²) dt`` with ``ẋ = -x³ + u``, ``x(0) = 1.5``,
``x(tf) = 1`` and a long fixed horizon (reference uses tf = 5000,
``Lpopc/example/hypersensitive/HyperSensitive.cpp``;
``doc/LpopcDoc.tex:1269-1288``). The solution has boundary layers at both ends
and is ~0 in between — the canonical stress test for hp mesh refinement.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.problem import Phase, Problem
from ..core.solve import SolveOptions, solve as _solve
from ..ops.lgr import uniform_fractions


def make_problem(tf: float = 5000.0, degrees=None, fractions=None) -> Problem:
    if degrees is None:
        # single segment, moderate degree — the reference's default first mesh
        # (meshpoints (-1,1); LpMeshRefiner.cpp:47-52)
        degrees = (20,)
    if fractions is None:
        fractions = uniform_fractions(len(degrees))

    phase = Phase(
        nx=1, nu=1,
        dynamics=lambda x, u, t, q: torch.stack([-x[0] ** 3 + u[0]]),
        lagrange=lambda x, u, t, q: 0.5 * (x[0] ** 2 + u[0] ** 2),
        x0_bounds=(1.5, 1.5),
        xf_bounds=(1.0, 1.0),
        x_bounds=(-50.0, 50.0),
        u_bounds=(-50.0, 50.0),
        t0_bounds=(0.0, 0.0),
        tf_bounds=(tf, tf),
        guess_t=np.array([0.0, tf]),
        guess_x=np.array([[1.5], [1.0]]),
        guess_u=np.array([[0.0], [0.0]]),
        mesh_degrees=tuple(degrees),
        mesh_fractions=tuple(fractions),
        name="hypersensitive",
    )
    return Problem(phases=(phase,), name="hypersensitive")


def solve(options: SolveOptions = None, *, device=None, dtype=torch.float64, **kw):
    return _solve(make_problem(**kw),
                  options or SolveOptions(max_grid_num=20, mesh_method="ph"),
                  device=device, dtype=dtype)
