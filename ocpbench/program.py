"""The system under test, ``lpopc_tpu_torch``, as the benchmark drives it.

The harness drives the program through this module and the traffic's mode
(``ocpbench/modes/<mode>.py``) alone. A mode is a file with two names:

- ``Program(config, traffic, device, dtype)``: builds the configuration's
  problem and solver; ``inputs(perturbations)`` turns one call's
  perturbations into the program's inputs, ``run(inputs)`` makes the call
  and returns (its result, the instances it solved), ``answers(results)``
  hands them back in the problem's own units; ``counters()``,
  ``reset_counters()``, ``close()``;
- ``numbers(cell, answers, pool, used)``: per instance, whether it was
  solved and the reference's numbers that judge it (``judge.py``).
"""

from __future__ import annotations

import importlib

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}
SOLVED = 1          # the status of an instance solved to tolerance (IPM and hp solve)


def options(config: dict, traffic: dict):
    from lpopc_tpu_torch.core.ipm import IPMOptions
    from lpopc_tpu_torch.core.solve import SolveOptions

    ipm = IPMOptions(**{**config.get("ipm_options", {}), "max_iter": int(traffic["max_iter"])})
    return SolveOptions(**config.get("solve_options", {}), ipm=ipm)


def problem(config: dict, traffic: dict):
    """The configuration's constructor, called with its ``args`` and the
    traffic's ``mesh`` as keywords (lists as tuples)."""
    module, fn = config["constructor"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), fn)
    mesh = {k: tuple(v) if isinstance(v, list) else v for k, v in traffic["mesh"].items()}
    return make(**config.get("args", {}), **mesh)


def _kernels():
    from lpopc_tpu_torch.ops import batched_linalg as bl

    return bl


def launches() -> dict:
    bl = _kernels()
    return {k: getattr(bl, k).launches for k in ("lane_cholesky", "lane_cho_solve")}


def reset_launches():
    _kernels().reset_launches()
