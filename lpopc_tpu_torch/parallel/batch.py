"""Instance-axis batching of IPM solves.

The reference C++ library is strictly single-process/single-thread; its
throughput story is 1/wall-clock. The scale-out here is an *instance axis*:
hundreds to thousands of perturbed problem instances (different initial
states, targets, pinned parameters) solve in lockstep on one GPU.

Because the IPM takes its bounds as runtime inputs, a perturbed-instance sweep
is pure data parallelism: every instance shares the solver; per-instance
``status`` keeps diverged instances from poisoning the batch. The solver
itself carries the batch dimension (see :mod:`..core.ipm`), so this module
only transcribes, scales and binds.

Not ported yet (each raises ``NotImplementedError``): sharding the instance
axis over several devices (``mesh=``), ``donate``, the f32→f64 ``two_stage``
cascade, and the pin-sensitivity read-outs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..core.ipm import IPMOptions, build_solver
from ..core.problem import Problem
from ..core.scaling import scale_nlp
from ..core.solve import SolveOptions, _bind_fixed_mesh, _kkt_factorizer, _kkt_structured
from ..core.transcribe import transcribe
from ..utils.device import resolve_device


@dataclass
class BatchSolver:
    """A batched solver for one problem family on a fixed mesh.

    ``run(z0, zl, zu, cl, cu)`` takes arrays (tensors, or numpy arrays that
    are moved to the solver's device) with a leading batch axis and returns
    the batched :class:`IPMResult`. Use :meth:`nominal_inputs` to get
    broadcast-ready nominal arrays to perturb.
    """

    problem: Problem
    nlp: object
    scaled: object
    run: Callable
    n: int
    m: int
    ipm_options: IPMOptions = None   # the RESOLVED options the solver runs
    device: object = None
    dtype: object = torch.float64
    solver: Callable = None          # the bound core.ipm solve (carries host_syncs)

    def nominal_inputs(self, batch: int):
        s = self.scaled
        tile = lambda a: np.broadcast_to(np.asarray(a), (batch,) + np.asarray(a).shape).copy()
        return (tile(s.z0), tile(s.zl), tile(s.zu), tile(s.cl), tile(s.cu))

    def x0_sensitivities(self, res, phase: int = 0):
        raise NotImplementedError(
            "pin sensitivities belong to the sensitivities slice of the port")

    def q_sensitivities(self, res, phase: int = 0):
        raise NotImplementedError(
            "pin sensitivities belong to the sensitivities slice of the port")

    def perturb_x0(self, batch: int, phase: int, deltas: np.ndarray):
        """Nominal inputs with the phase-``phase`` initial state shifted by
        ``deltas`` (batch, nx) — the canonical MPC/perturbation sweep input.

        Only states with equal lower/upper bounds (pinned x0) are shifted.
        """
        z0, zl, zu, cl, cu = self.nominal_inputs(batch)
        pl = self.nlp.layout.phases[phase]
        nx = pl.nx
        var_scale = self.scaled.var_scale[pl.var_offset : pl.var_offset + nx]
        d = np.asarray(deltas) * var_scale[None, :]
        sl = slice(pl.var_offset, pl.var_offset + nx)
        pinned = (zu[:, sl] - zl[:, sl]) < 1e-12
        zl[:, sl] = np.where(pinned, zl[:, sl] + d, zl[:, sl])
        zu[:, sl] = np.where(pinned, zu[:, sl] + d, zu[:, sl])
        # only shift the warm start where the bounds actually moved
        z0[:, sl] = np.where(pinned, z0[:, sl] + d, z0[:, sl])
        return z0, zl, zu, cl, cu


def make_batch_solver(
    problem: Problem,
    options: SolveOptions = SolveOptions(),
    mesh=None,
    donate: bool = False,
    two_stage: bool = False,
    stage1_tol: float = 1e-3,
    stage1_max_iter: int = 40,
    *,
    device=None,
    dtype=torch.float64,
) -> BatchSolver:
    """Build the batched IPM solver of ``problem`` on its current mesh.

    ``device=None`` means ``"cuda"``: without a CUDA device this raises, it
    never carries on on the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels (the tests do).
    """
    from ..core.options import validate

    device = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (sharding the instance axis over devices) belongs to the "
            "scale-out slice of the port")
    if donate:
        raise NotImplementedError(
            "donate belongs to the scale-out slice of the port")
    if two_stage:
        raise NotImplementedError(
            "two_stage (the f32->f64 cascade) belongs to the "
            "scale-out slice of the port")
    options = validate(options)
    nlp = transcribe(problem, device=device, dtype=dtype)
    scaled = scale_nlp(
        nlp.objective, nlp.constraints, nlp.zl, nlp.zu, nlp.cl, nlp.cu, nlp.z0,
        enabled=options.auto_scale, variable_scaling=options.variable_scaling,
        samples=options.scale_samples, device=device, dtype=dtype,
    )
    # the block path (n >= block_kkt_threshold under "auto", or "on") runs on
    # the per-node blocks alone: the dense assemblers are then not built
    sk = _kkt_structured(problem, nlp, options)
    jac_fn = hess_fn = bound_sk = kkt_fact = None
    if sk is not None:
        bound_sk = _bind_fixed_mesh(sk, nlp, scaled, device, dtype)
    else:
        if getattr(options, "structured_derivatives", True):
            from ..core.structured import make_structured_hessian, make_structured_jacobian

            jac_fn, hess_fn = scaled.wrap_structured(
                make_structured_jacobian(
                    problem, nlp.layout, nlp.ops, device=device, dtype=dtype),
                make_structured_hessian(
                    problem, nlp.layout, nlp.ops,
                    gauss_newton=(options.hessian_approximation == "gauss-newton"),
                    device=device, dtype=dtype,
                ),
            )
        kkt_fact = _kkt_factorizer(nlp, options)
    ipm_base = options.ipm_options()
    if ipm_base.soc is None:
        # Lockstep sweep surface: every instance-iteration pays the
        # second-order-correction cost while the filter accepts first trials
        # essentially always — resolve the surface default OFF here. Pass
        # IPMOptions(soc=True) to force it for hard sweeps.
        ipm_base = replace(ipm_base, soc=False)
    solver = build_solver(
        scaled.objective, scaled.constraints, nlp.n, nlp.m, ipm_base,
        jac_fn=jac_fn, hess_fn=hess_fn,
        kkt_factorizer=kkt_fact, structured_kkt=bound_sk,
    )

    def to_dev(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    def run(z0, zl, zu, cl, cu, lam0=None, zl_d=None, zu_d=None):
        # warm-dual variant (receding-horizon re-solves): zl_d/zu_d carry the
        # bound duals of the previous solve; the IPM then starts mu at the
        # carried complementarity instead of mu_init.
        return solver(
            to_dev(z0), to_dev(zl), to_dev(zu), to_dev(cl), to_dev(cu),
            lam0=to_dev(lam0), zl_d_init=to_dev(zl_d), zu_d_init=to_dev(zu_d),
        )

    return BatchSolver(
        problem=problem, nlp=nlp, scaled=scaled, run=run, n=nlp.n, m=nlp.m,
        ipm_options=ipm_base, device=device, dtype=dtype, solver=solver,
    )
