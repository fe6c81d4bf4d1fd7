"""Checkpoint / resume for the hp-refinement outer loop.

The reference has no checkpointing; its closest mechanism is warm-starting
across meshes via the Phase guess containers (``Nlp2OPConverter.cpp:160-193``).
Here each refinement grid's state — mesh configuration, primal/dual vectors,
trajectories — is saved to ``.npz``; :func:`resume_problem` reconstructs a
warm-started problem from the latest checkpoint so a long refinement run can
continue after interruption.

The file layout is the JAX package's (``utils/checkpoint.py``): the same
array names and the same JSON ``meta`` record stored as ``uint8`` bytes, so a
checkpoint written by either package resumes in the other. A
:class:`..core.postprocess.Solution` holds host numpy arrays, so nothing here
touches a device.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np

from ..core.postprocess import Solution
from ..core.problem import Problem


def save_checkpoint(sol: Solution, problem: Problem, directory: str, grid: int) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"grid_{grid:03d}.npz")
    meta = {
        "grid": grid,
        "status": sol.status,
        "objective": sol.objective,
        "kkt_error": sol.kkt_error,
        "max_relative_error": float(sol.max_relative_error),
        "meshes": [
            {"degrees": list(ph.mesh_degrees), "fractions": list(ph.mesh_fractions)}
            for ph in problem.phases
        ],
    }
    arrays = {"z": sol.z, "lam": sol.lam, "meta": np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)}
    for i, ps in enumerate(sol.phases):
        arrays[f"t_state_{i}"] = ps.t_state
        arrays[f"x_{i}"] = ps.x
        arrays[f"t_col_{i}"] = ps.t_col
        arrays[f"u_{i}"] = ps.u
        arrays[f"q_{i}"] = ps.q
    np.savez(path, **arrays)
    return path


def latest_checkpoint(directory: str):
    paths = sorted(glob.glob(os.path.join(directory, "grid_*.npz")))
    return paths[-1] if paths else None


def load_checkpoint(path: str):
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    return data, meta


def resume_problem(problem: Problem, directory: str):
    """(problem', grid) warm-started from the latest checkpoint, or
    (problem, 0) when none exists."""
    path = latest_checkpoint(directory)
    if path is None:
        return problem, 0
    data, meta = load_checkpoint(path)
    new_phases = []
    for i, ph in enumerate(problem.phases):
        mesh = meta["meshes"][i]
        t = data[f"t_state_{i}"]
        x = data[f"x_{i}"]
        u = data[f"u_{i}"]
        if ph.nu > 0:
            # extend control to the endpoint for the guess grid
            u_full = np.vstack([u, u[-1:]])
        else:
            u_full = None
        ph2 = ph.with_mesh(mesh["degrees"], mesh["fractions"]).with_guess(
            t, x, u_full, data[f"q_{i}"] if ph.nq else None
        )
        new_phases.append(ph2)
    return (
        dataclasses.replace(problem, phases=tuple(new_phases)),
        int(meta["grid"]),
    )
