"""Carry state between the JAX package and the port, as numpy.

The two packages never import each other. What crosses between them — the
nominal inputs of a batch solver, the scale vectors of a scaled NLP, the
fields of a solve result, an hp solve's :class:`Solution`, a data table's
coefficients — crosses as numpy arrays through these functions, so that tests feed both sides the same
inputs and warm-start one from the other's result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.ipm import IPMResult
from ..core.postprocess import PhaseSolution, Solution
from ..ops.tables import Spline1D, Spline2D
from .device import resolve_device

_INT_FIELDS = ("status", "iterations")
_FIELDS = ("z", "s", "lam", "zl_dual", "zu_dual", "status", "iterations",
           "objective", "kkt_error", "mu", "delta_w")


def inputs_from_reference(z0, zl, zu, cl, cu, *, device=None, dtype=torch.float64):
    """``(z0, zl, zu, cl, cu)`` numpy (or array-like) -> tensors on ``device``
    (``None`` means ``"cuda"``), ready for ``BatchSolver.run`` / ``solve``."""
    device = resolve_device(device)
    return tuple(
        torch.as_tensor(np.array(a, dtype=np.float64), device=device, dtype=dtype)
        for a in (z0, zl, zu, cl, cu)
    )


def result_from_reference(fields: dict, *, device=None, dtype=torch.float64) -> IPMResult:
    """A dict of numpy arrays holding an ``IPMResult``'s fields (as the JAX
    package returns them, batched) -> the port's :class:`IPMResult`."""
    device = resolve_device(device)
    out = {}
    for name in _FIELDS:
        a = np.array(fields[name])
        if name in _INT_FIELDS:
            out[name] = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            out[name] = torch.as_tensor(a.astype(np.float64), device=device, dtype=dtype)
    hist = fields.get("history")
    if hist is not None:
        hist = {k: torch.as_tensor(np.array(v), device=device) for k, v in hist.items()}
    return IPMResult(history=hist, **out)


def result_to_numpy(res: IPMResult) -> dict:
    """The port's result as a dict of numpy arrays (the inverse direction)."""
    out = {name: getattr(res, name).detach().cpu().numpy() for name in _FIELDS}
    out["history"] = (
        None if res.history is None
        else {k: v.detach().cpu().numpy() for k, v in res.history.items()}
    )
    return out


def solution_from_reference(ref) -> Solution:
    """The port's :class:`Solution` from a JAX package ``Solution`` (read
    field by field, so any object with the same fields will do). Every
    array is copied to numpy; lists of arrays (``error_history``) and the
    per-grid rows are copied one level deep."""
    def copy(v):
        if isinstance(v, np.ndarray):
            return np.array(v)
        if isinstance(v, list):
            return [copy(x) for x in v]
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        return v

    phases = [
        PhaseSolution(**{f.name: copy(getattr(p, f.name))
                         for f in dataclasses.fields(PhaseSolution)})
        for p in ref.phases
    ]
    rest = {f.name: copy(getattr(ref, f.name))
            for f in dataclasses.fields(Solution)
            if f.name != "phases" and hasattr(ref, f.name)}
    return Solution(phases=phases, **rest)


def spline_from_reference(ref):
    """The port's :class:`Spline1D` or :class:`Spline2D` holding a JAX
    package table's coefficients as they are (no refit): ``xs``, ``ys``,
    ``ms`` for a 1-D table, ``xs``, ``ys``, ``z``, ``mx``, ``my``, ``mxy``
    for a 2-D one, read field by field as float64 numpy."""
    def arr(name):
        return torch.as_tensor(np.array(getattr(ref, name), dtype=np.float64))

    if hasattr(ref, "z"):
        return Spline2D(*(arr(k) for k in ("xs", "ys", "z", "mx", "my", "mxy")))
    return Spline1D(*(arr(k) for k in ("xs", "ys", "ms")))
